"""whisper-medium [arXiv:2212.04356] — encoder-decoder.

24L encoder + 24L decoder, d_model=1024, 16 heads MHA, d_ff=4096 (gelu),
vocab 51865. The conv/audio frontend is a STUB: input_specs provide
precomputed frame embeddings [B, 1500, d_model]; the encoder uses absolute
sinusoidal positions (no rope), the decoder has self-attn + cross-attn.
"""
from ..models.config import AttnSpec, EncoderConfig, FfnSpec, ModelConfig

_SELF = dict(n_heads=16, n_kv=16, head_dim=64, rope="none")


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        d_model=1024, vocab=51865, n_groups=24,
        pattern=((AttnSpec(**_SELF),
                  AttnSpec(**_SELF, cross=True, causal=False),
                  FfnSpec(d_ff=4096, act="gelu")),),
        encoder=EncoderConfig(
            n_groups=24,
            pattern=((AttnSpec(**_SELF, causal=False),
                      FfnSpec(d_ff=4096, act="gelu")),),
            n_frames=1500),
        max_seq=32768, tie_embeddings=True, modality="audio",
        norm="layernorm",
    )


def reduced() -> ModelConfig:
    small = dict(n_heads=4, n_kv=4, head_dim=16, rope="none")
    return ModelConfig(
        name="whisper-medium-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=((AttnSpec(**small),
                  AttnSpec(**small, cross=True, causal=False),
                  FfnSpec(d_ff=128, act="gelu")),),
        encoder=EncoderConfig(
            n_groups=2,
            pattern=((AttnSpec(**small, causal=False),
                      FfnSpec(d_ff=128, act="gelu")),),
            n_frames=32),
        max_seq=128, tie_embeddings=True, modality="audio",
        norm="layernorm",
    )
