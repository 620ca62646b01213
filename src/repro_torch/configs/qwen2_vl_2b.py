"""qwen2-vl-2b [arXiv:2409.12191] — VLM backbone with M-RoPE.

28L, d_model=1536, 12 heads / 2 kv (GQA), head_dim=128, SwiGLU d_ff=8960,
vocab 151936. The vision frontend is a STUB: input_specs provide
precomputed patch embeddings [B, S_vis, d_model] plus 3-axis (t,h,w)
M-RoPE position ids.
"""
from ..models.config import AttnSpec, FfnSpec, ModelConfig

_ATTN = dict(n_heads=12, n_kv=2, head_dim=128, rope="mrope",
             mrope_sections=(16, 24, 24))


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        d_model=1536, vocab=151936, n_groups=28,
        pattern=((AttnSpec(**_ATTN), FfnSpec(d_ff=8960)),),
        max_seq=32768, rope_theta=1e6, tie_embeddings=True,
        modality="vlm", vision_frac=0.25,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-reduced",
        d_model=64, vocab=512, n_groups=2,
        pattern=((AttnSpec(n_heads=4, n_kv=2, head_dim=16, rope="mrope",
                           mrope_sections=(2, 3, 3)),
                  FfnSpec(d_ff=128)),),
        max_seq=128, rope_theta=1e4, tie_embeddings=True,
        modality="vlm", vision_frac=0.25,
    )
