"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407] — 128k ctx.

40L, d_model=5120, 32 heads / 8 kv (GQA), head_dim=128, SwiGLU d_ff=14336,
vocab 131072.
"""
from ..models.config import AttnSpec, FfnSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        d_model=5120, vocab=131072, n_groups=40,
        pattern=((AttnSpec(n_heads=32, n_kv=8, head_dim=128),
                  FfnSpec(d_ff=14336)),),
        max_seq=131072, rope_theta=1e6, tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=((AttnSpec(n_heads=4, n_kv=2, head_dim=16),
                  FfnSpec(d_ff=192)),),
        max_seq=128, rope_theta=1e4, tie_embeddings=False,
    )
