"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B family].

94L, d_model=4096, 64 q heads / 4 kv heads (GQA), head_dim=128, per-expert
d_ff=1536, 128 experts top-8, vocab 151936, qk-norm (qwen3), rope 1e6.
"""
from ..models.config import AttnSpec, ModelConfig, MoeSpec

_ATTN = dict(n_heads=64, n_kv=4, head_dim=128, qk_norm=True)
_MOE = dict(n_experts=128, top_k=8, d_ff=1536)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        d_model=4096, vocab=151936, n_groups=94,
        pattern=((AttnSpec(**_ATTN), MoeSpec(**_MOE)),),
        max_seq=32768, rope_theta=1e6, tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=((AttnSpec(n_heads=4, n_kv=2, head_dim=16, qk_norm=True),
                  MoeSpec(n_experts=8, top_k=2, d_ff=96)),),
        max_seq=128, rope_theta=1e4, tie_embeddings=False,
    )
