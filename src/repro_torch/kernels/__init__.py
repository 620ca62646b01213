"""Hand-written Hopper kernels, one package each:
`ops.py` holds the wrapper (kernel on a CUDA tensor, plain version on a
CPU tensor, nothing else) with its launch counter, `ref.py` the plain
PyTorch version, and `csrc/<name>.cu` the CUDA C++ source.

Each replaces one Pallas TPU kernel of the reference package
(`src/repro/kernels/<name>/kernel.py`)."""
from __future__ import annotations

from typing import Dict

from .ann_topk.ops import ann_topk
from .cuckoo_probe.ops import cuckoo_probe
from .decode_attention.ops import decode_attention
from .flash_attention.ops import flash_attention
from .reuse_sketch.ops import reuse_sketch_update
from .rmsnorm.ops import rmsnorm

WRAPPERS = {"rmsnorm": rmsnorm, "decode_attention": decode_attention,
            "flash_attention": flash_attention,
            "cuckoo_probe": cuckoo_probe, "ann_topk": ann_topk,
            "reuse_sketch": reuse_sketch_update}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
