"""xlstm-350m [arXiv:2405.04517].

24 blocks, d_model=1024, 4 heads, alternating mLSTM / sLSTM (the paper's
mixed-stack variant), vocab 50304. No separate FFN (d_ff=0): the blocks
carry their own up/down projections. Fully recurrent -> runs long_500k.
"""
from ..models.config import MLstmSpec, ModelConfig, SLstmSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        d_model=1024, vocab=50304, n_groups=12,
        pattern=((MLstmSpec(n_heads=4),), (SLstmSpec(n_heads=4),)),
        max_seq=524288, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=((MLstmSpec(n_heads=2, chunk=16),),
                 (SLstmSpec(n_heads=2),)),
        max_seq=128, tie_embeddings=True,
    )
