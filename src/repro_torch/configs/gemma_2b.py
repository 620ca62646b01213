"""gemma-2b [arXiv:2403.08295].

18L, d_model=2048, 8 heads / 1 kv (MQA), head_dim=256, GeGLU d_ff=16384,
vocab 256000, embeddings scaled by sqrt(d_model), tied.
"""
from ..models.config import AttnSpec, FfnSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        d_model=2048, vocab=256000, n_groups=18,
        pattern=((AttnSpec(n_heads=8, n_kv=1, head_dim=256),
                  FfnSpec(d_ff=16384, act="geglu")),),
        max_seq=8192, rope_theta=1e4, tie_embeddings=True,
        embed_scale=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=((AttnSpec(n_heads=4, n_kv=1, head_dim=32),
                  FfnSpec(d_ff=256, act="geglu")),),
        max_seq=128, rope_theta=1e4, tie_embeddings=True,
        embed_scale=True,
    )
