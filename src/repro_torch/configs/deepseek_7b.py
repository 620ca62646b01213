"""deepseek-7b [arXiv:2401.02954] — llama-arch dense.

30L, d_model=4096, 32 heads MHA (kv=32), head_dim=128, SwiGLU d_ff=11008,
vocab 102400.
"""
from ..models.config import AttnSpec, FfnSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        d_model=4096, vocab=102400, n_groups=30,
        pattern=((AttnSpec(n_heads=32, n_kv=32, head_dim=128),
                  FfnSpec(d_ff=11008)),),
        max_seq=32768, rope_theta=1e4, tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=((AttnSpec(n_heads=4, n_kv=4, head_dim=16),
                  FfnSpec(d_ff=160)),),
        max_seq=128, rope_theta=1e4, tie_embeddings=False,
    )
