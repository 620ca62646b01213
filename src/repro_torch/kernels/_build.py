"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers, so a
build takes seconds). The build happens at first use, from the sources
in this checkout only, into `build/repro_torch/` at the checkout's root;
all sources compile at once, one `nvcc` process each. Library names carry
a digest of the sources and flags, so an edited kernel is rebuilt and a
stale library is never loaded.

Nothing here runs at import time: the CPU-only test environment imports
every module and has no `nvcc`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("rmsnorm", "decode_attention", "flash_attention", "cuckoo_probe",
           "ann_topk", "reuse_sketch", "rmsnorm_bwd", "flash_attention_bwd")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of each library's C entry point (see the .cu sources)
SIGNATURES = {
    "rmsnorm": ("rmsnorm_fwd", [_P] * 5 + [_LL, _I, _F, _I, _P]),
    "decode_attention": (
        "decode_attention_fwd",
        [_P] * 9 + [_I] * 6 + [_LL] * 10 + [_F, _F, _I, _I, _P]),
    "flash_attention": (
        "flash_attention_fwd",
        [_P] * 4 + [_I] * 6 + [_LL] * 9 + [_F, _F, _I, _I, _I, _P]),
    "cuckoo_probe": ("cuckoo_probe_fwd",
                     [_P] * 5 + [_LL, _I, _I, _LL, _LL, _P]),
    "ann_topk": ("ann_topk_fwd", [_P] * 7 + [_I, _LL] + [_I] * 4 + [_P]),
    "reuse_sketch": ("reuse_sketch_fwd",
                     [_P] * 6 + [_LL, _I, _I, _I, _F, _F, _P]),
    "rmsnorm_bwd": ("rmsnorm_bwd", [_P] * 7 + [_LL, _LL, _I, _F, _I, _P]),
    "flash_attention_bwd": (
        "flash_attention_bwd",
        [_P] * 12 + [_I] * 6 + [_LL] * 9 + [_F, _F, _I, _I, _I, _P]),
}
# further C entry points, {name: (source, function, argtypes)}: queries a
# wrapper makes of the card before it launches
QUERIES = {
    "ann_topk_blocks_per_sm": ("ann_topk", "ann_topk_blocks_per_sm", [_I]),
    "rmsnorm_plan_of": ("rmsnorm", "rmsnorm_plan_of", [_LL, _I, _I, _I, _P]),
    "cuckoo_probe_plan_of": ("cuckoo_probe", "cuckoo_probe_plan_of",
                             [_LL, _I, _I, _P]),
    "flash_attention_bwd_smem": ("flash_attention_bwd",
                                 "flash_attention_bwd_smem", [_I, _I]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cuda_nvcc.is_file():
        return str(cuda_nvcc)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU")


def _digest() -> str:
    h = hashlib.blake2b(digest_size=8)
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build() -> Dict[str, object]:
    """Compile every kernel source (in parallel) unless its library for
    these exact sources already exists. Returns {"seconds": wall time,
    "logs": {name: ptxas resource report}}; raises RuntimeError naming
    the source on any compile failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    procs = {}
    for name in SOURCES:
        lib = BUILD_DIR / f"{name}-{digest}.so"
        if lib.is_file():
            continue
        tmp = BUILD_DIR / f"{name}-{digest}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        (BUILD_DIR / f"{name}-{digest}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "logs": logs}


@functools.cache
def library(name: str):
    """The C entry point of kernel `name` (or of a query in QUERIES),
    built on first use."""
    source, fn_name, argtypes = QUERIES.get(name) or (name,
                                                      *SIGNATURES[name])
    build()
    lib = ctypes.CDLL(str(BUILD_DIR / f"{source}-{_digest()}.so"))
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t "
                           f"{err}")
