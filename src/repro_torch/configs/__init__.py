"""Architecture registry: the reference package's 10 architectures (+
reduced smoke variants). `get_config` builds those the port can already
run and raises NotImplementedError for the others. The dense
attention + FFN family, the MoE family, the Mamba-2 hybrid, xLSTM, the
vision-language backbone (qwen2-vl-2b) and the encoder-decoder
(whisper-medium) are ported, one config at a time: every one of the
ten."""
from __future__ import annotations

import importlib
from ..models.config import ModelConfig

ARCHS = (
    "qwen3-moe-235b-a22b",
    "llama4-maverick-400b-a17b",
    "xlstm-350m",
    "deepseek-7b",
    "granite-20b",
    "gemma-2b",
    "mistral-nemo-12b",
    "whisper-medium",
    "qwen2-vl-2b",
    "zamba2-7b",
)

# archs with a config module in this package: the dense attention + FFN
# family, the MoE configs, zamba2's Mamba-2 stack with its shared
# attention, xlstm's mLSTM / sLSTM stack, qwen2-vl's M-RoPE backbone
# with its vision prefix and whisper's encoder and cross-attending
# decoder (without the features models.model does not build yet), one
# config at a time
PORTED = ("gemma-2b", "deepseek-7b", "mistral-nemo-12b", "granite-20b",
          "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "zamba2-7b",
          "xlstm-350m", "qwen2-vl-2b", "whisper-medium")

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MOD)}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; ported: {list(PORTED)}")
    mod = importlib.import_module(f".{_MOD[name]}", __package__)
    return mod.reduced() if reduced else mod.config()

