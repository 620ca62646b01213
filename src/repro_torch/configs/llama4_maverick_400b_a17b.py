"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Maverick family].

48L, d_model=5120, 40 heads / 8 kv (GQA), head_dim=128, d_ff=8192, vocab
202048. MoE on alternating layers (interleave step 2, as in Maverick):
128 experts top-1 plus an always-on shared expert; dense FFN on the other
layers. Expressed as a 2-layer group scanned 24x.
"""
from ..models.config import AttnSpec, FfnSpec, ModelConfig, MoeSpec

_ATTN = dict(n_heads=40, n_kv=8, head_dim=128)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        d_model=5120, vocab=202048, n_groups=24,
        pattern=(
            (AttnSpec(**_ATTN), FfnSpec(d_ff=8192)),
            (AttnSpec(**_ATTN),
             MoeSpec(n_experts=128, top_k=1, d_ff=8192, shared_d_ff=8192)),
        ),
        max_seq=32768, rope_theta=5e5, tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=(
            (AttnSpec(n_heads=4, n_kv=2, head_dim=16), FfnSpec(d_ff=128)),
            (AttnSpec(n_heads=4, n_kv=2, head_dim=16),
             MoeSpec(n_experts=4, top_k=1, d_ff=128, shared_d_ff=128)),
        ),
        max_seq=128, rope_theta=1e4, tie_embeddings=False,
    )
