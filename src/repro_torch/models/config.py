"""Composable decoder-stack IR.

A model is a stack of *groups*; each group is a tuple of *layers*; each
layer is a tuple of *sublayers* (pre-norm residual units). Groups are
homogeneous, so their parameters stack along a leading [G] axis exactly as
in the reference package (the same tree moves between the two packages).

Sublayer kinds (the port builds every one; `models.model` raises
NotImplementedError for the attention features it does not build yet):
  AttnSpec    multi-head attention (GQA/MQA/MHA, RoPE or M-RoPE, optional
              cross-attention and cross-stack weight sharing)
  FfnSpec     dense gated/plain MLP
  MoeSpec     mixture-of-experts with top-k routing + static capacity
  Mamba2Spec  Mamba-2 state-space duality block (chunked scan)
  MLstmSpec   xLSTM matrix-memory block (chunked parallel form)
  SLstmSpec   xLSTM scalar-memory block (sequential recurrence)

Heterogeneous stacks (llama4 alternating dense/MoE, zamba2 mamba+shared
attention, xLSTM mLSTM/sLSTM interleave) are expressed inside the repeated
group; a non-repeating `tail` covers remainders (e.g. zamba2's 81 = 13*6+3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv: int
    head_dim: int
    rope: str = "rope"               # "rope" | "mrope" | "none"
    causal: bool = True
    cross: bool = False              # K/V from encoder stream
    shared: bool = False             # weights shared across all occurrences
    qk_norm: bool = False            # per-head RMSNorm on q,k (qwen3)
    sliding_window: int = 0          # 0 = full attention
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # head_dim/2 split
    logit_softcap: float = 0.0

    @property
    def kind(self) -> str:
        return "attn"


@dataclasses.dataclass(frozen=True)
class FfnSpec:
    d_ff: int
    act: str = "swiglu"              # "swiglu" | "geglu" | "gelu" | "relu2"
    shared: bool = False

    @property
    def kind(self) -> str:
        return "ffn"


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    n_experts: int
    top_k: int
    d_ff: int
    act: str = "swiglu"
    capacity_factor: float = 1.25
    shared_d_ff: int = 0             # always-on shared expert (llama4)
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"

    @property
    def kind(self) -> str:
        return "moe"


@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1                # B/C parameter groups

    @property
    def kind(self) -> str:
        return "mamba2"


@dataclasses.dataclass(frozen=True)
class MLstmSpec:
    n_heads: int
    proj_factor: float = 2.0
    d_conv: int = 4
    chunk: int = 128

    @property
    def kind(self) -> str:
        return "mlstm"


@dataclasses.dataclass(frozen=True)
class SLstmSpec:
    n_heads: int
    proj_factor: float = 4.0 / 3.0
    d_conv: int = 4

    @property
    def kind(self) -> str:
        return "slstm"


Layer = Tuple[object, ...]           # sequence of sublayer specs
Group = Tuple[Layer, ...]            # layers scanned together


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). The modality frontend is
    a stub: inputs are precomputed frame embeddings (B, n_frames, d_model)."""

    n_groups: int
    pattern: Group
    n_frames: int = 1500
    pos: str = "sinusoidal"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    n_groups: int
    pattern: Group
    tail: Group = ()
    max_seq: int = 4096
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    rope_theta: float = 1e6
    embed_scale: bool = False        # gemma multiplies embeds by sqrt(d)
    final_logit_softcap: float = 0.0
    encoder: Optional[EncoderConfig] = None
    modality: str = "text"           # "text" | "audio" | "vlm"
    vision_frac: float = 0.25        # VLM: fraction of seq that is patches

    # ---- derived -----------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return self.n_groups * len(self.pattern) + len(self.tail)

    def sublayers(self):
        """Iterate (where, layer_idx, sub_idx, spec): where in {pattern,tail}."""
        for li, layer in enumerate(self.pattern):
            for si, spec in enumerate(layer):
                yield "pattern", li, si, spec
        for li, layer in enumerate(self.tail):
            for si, spec in enumerate(layer):
                yield "tail", li, si, spec

    @property
    def has_attention(self) -> bool:
        return any(s.kind == "attn" for _, _, _, s in self.sublayers())

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state does not grow O(seq) per full-attn layer —
        SSM / linear-attention families. Determines long_500k eligibility."""
        kinds = {s.kind for _, _, _, s in self.sublayers()}
        full_attn_layers = sum(
            1 for _, _, _, s in self.sublayers()
            if s.kind == "attn" and s.sliding_window == 0 and not s.cross)
        recurrent = kinds & {"mamba2", "mlstm", "slstm"}
        # hybrid archs qualify if recurrence dominates (zamba2: 13 shared-attn
        # applications vs 81 mamba layers)
        return bool(recurrent) and full_attn_layers <= max(
            1, self.n_layers // 4)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stack), for 6ND roofline."""
        d = self.d_model
        n = self.vocab * d * (1 if self.tie_embeddings else 2)

        def sub_params(s) -> int:
            if s.kind == "attn":
                qo = d * s.n_heads * s.head_dim * 2
                kv = d * s.n_kv * s.head_dim * 2
                return qo + kv + (2 * s.head_dim if s.qk_norm else 0)
            if s.kind == "ffn":
                mult = 3 if s.act in ("swiglu", "geglu") else 2
                return mult * d * s.d_ff
            if s.kind == "moe":
                mult = 3 if s.act in ("swiglu", "geglu") else 2
                n_ = s.n_experts * mult * d * s.d_ff + d * s.n_experts
                if s.shared_d_ff:
                    n_ += mult * d * s.shared_d_ff
                return n_
            if s.kind == "mamba2":
                d_in = s.expand * d
                nh = d_in // s.head_dim
                return (d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                        + d_in * d + s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
                        + 2 * nh + d_in)
            if s.kind == "mlstm":
                d_in = int(s.proj_factor * d)
                return (2 * d * d_in            # up-proj (u + out gate)
                        + 3 * d_in * d_in       # wq, wk, wv
                        + d_in * d              # down-proj
                        + d_in * (s.d_conv + 2)  # conv + biases + norm
                        + 4 * s.n_heads)        # i/f gate proj + bias
            if s.kind == "slstm":
                P = d // s.n_heads
                d_up = int(s.proj_factor * d)
                return (4 * d * d               # w_gates (z i f o)
                        + 4 * s.n_heads * P * P  # block-diag recurrent
                        + 3 * d * d_up          # gated up/down proj
                        + d * (s.d_conv + 6))   # conv + biases + gn
            return 0

        shared_seen = set()
        for where, li, si, s in self.sublayers():
            reps = self.n_groups if where == "pattern" else 1
            if getattr(s, "shared", False):
                if s not in shared_seen:
                    shared_seen.add(s)
                    n += sub_params(s) + 2 * d  # + its norm
                continue
            n += reps * (sub_params(s) + d)    # + pre-norm scale
        n += d                                  # final norm
        if self.encoder is not None:
            for layer in self.encoder.pattern:
                for s in layer:
                    n += self.encoder.n_groups * (sub_params(s) + d)
            n += d
        return int(n)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        d = self.d_model
        n = self.param_count()
        for where, li, si, s in self.sublayers():
            if s.kind != "moe":
                continue
            reps = self.n_groups if where == "pattern" else 1
            mult = 3 if s.act in ("swiglu", "geglu") else 2
            inactive = (s.n_experts - s.top_k) * mult * d * s.d_ff
            n -= reps * inactive
        return int(n)
