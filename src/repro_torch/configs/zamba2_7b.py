"""zamba2-7b [arXiv:2411.15242] — Mamba2 backbone + shared attention.

81 layers, d_model=3584, ssm_state=64, mamba head_dim=64 (d_inner=7168,
112 heads). A *weight-shared* attention+FFN block (32 heads MHA,
d_ff=14336) is applied every 6th mamba layer (13 applications over the
13x6=78 scanned layers; the remaining 3 mamba layers form the tail).
Sub-quadratic (recurrent state dominates) -> runs long_500k.
"""
from ..models.config import AttnSpec, FfnSpec, Mamba2Spec, ModelConfig

_MAMBA = Mamba2Spec(d_state=64, head_dim=64, expand=2)
_SHARED_ATTN = AttnSpec(n_heads=32, n_kv=32, head_dim=112, shared=True)
_SHARED_FFN = FfnSpec(d_ff=14336, shared=True)


def config() -> ModelConfig:
    mamba_layer = (_MAMBA,)
    return ModelConfig(
        name="zamba2-7b",
        d_model=3584, vocab=32000, n_groups=13,
        pattern=(mamba_layer,) * 5 + (
            (_SHARED_ATTN, _SHARED_FFN, _MAMBA),),
        tail=(mamba_layer,) * 3,
        max_seq=524288, rope_theta=1e4, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    m = Mamba2Spec(d_state=16, head_dim=16, expand=2, chunk=16)
    return ModelConfig(
        name="zamba2-7b-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=((m,), (AttnSpec(n_heads=4, n_kv=4, head_dim=16,
                                 shared=True),
                        FfnSpec(d_ff=128, shared=True), m)),
        tail=((m,),),
        max_seq=128, rope_theta=1e4, tie_embeddings=True,
    )
