"""granite-20b [arXiv:2405.04324] — code model, llama-arch, MQA.

52L, d_model=6144, 48 heads / 1 kv (MQA), head_dim=128, d_ff=24576 (gelu),
vocab 49152.
"""
from ..models.config import AttnSpec, FfnSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        d_model=6144, vocab=49152, n_groups=52,
        pattern=((AttnSpec(n_heads=48, n_kv=1, head_dim=128),
                  FfnSpec(d_ff=24576, act="gelu")),),
        max_seq=32768, rope_theta=1e4, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=((AttnSpec(n_heads=4, n_kv=1, head_dim=16),
                  FfnSpec(d_ff=256, act="gelu")),),
        max_seq=128, rope_theta=1e4, tie_embeddings=True,
    )
