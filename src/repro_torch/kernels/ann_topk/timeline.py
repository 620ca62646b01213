"""Per-phase timeline of the ann_topk first pass on the card.

Builds `csrc/ann_topk.cu` once more with -DANN_TIMELINE, whose thread 0
of every first-pass block adds up the SM clock's cycles of each phase
(wait: the copies and each step's barrier; products; tile: |c|^2 and
the tile's barrier; filter: filtering and appending the survivors;
merges: the barrier that looks for full buffers, the rounds that merge
them and the last merges; in_merge: of these, the time inside its own
warp's merges) and whose block counts its merge rounds, merges and
survivors. It runs one call per k
behind a spin kernel and gives the medians over blocks, phases in us at
the measured SM clock. It reads clock stamps only and needs no profiler.

    PYTHONPATH=src python3 -m repro_torch.kernels.ann_topk.timeline \\
        [--k 1 64 256]

The CLI takes stage 1's shape: the reduced 128-d rows of the corpus of
262,144 vectors and its 1024 queries (`ann.corpus`, seed 0).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from .. import _build
from . import ops

PHASES = ("wait", "products", "tile", "filter", "merges", "in_merge")
COUNTS = ("n_rounds", "n_merges", "n_survivors")
STAMPS = len(PHASES) + 6          # kAnnStamps in the source


def _library():
    so = _build.BUILD_DIR / f"ann_topk_timeline-{_build._digest()}.so"
    if not so.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DANN_TIMELINE", "-I",
               str(_build.CSRC), "-o", str(so),
               str(_build.CSRC / "ann_topk.cu")]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.ann_topk_fwd
    fn.argtypes = _build.SIGNATURES["ann_topk"][1]
    fn.restype = ctypes.c_int
    read = lib.ann_topk_timeline
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    per_sm = lib.ann_topk_blocks_per_sm
    per_sm.argtypes = [ctypes.c_int]
    per_sm.restype = ctypes.c_int
    return fn, read, per_sm


def run(queries: torch.Tensor, corpus: torch.Tensor, ks=(1, 64, 256)) \
        -> dict:
    """The timeline of one call per k on CUDA tensors queries [Q, D] and
    corpus [N, D] float32 (the full pass, bounded as the wrapper bounds
    it): {k: {phase: us, count: n}} medians over the first-pass blocks,
    and the kernel's span from the first block's start to the last
    block's exit."""
    fn, read, per_sm = _library()
    Q, D = queries.shape
    N = corpus.shape[0]
    dev = queries.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {"device": torch.cuda.get_device_name(dev),
           "shape": [Q, N, D], "k": {}}
    for k in ks:
        n_splits, per = ops.split_plan(Q, N, n_sm, per_sm(k))
        n = -(-Q // ops.BLOCK_Q) * n_splits
        part_d = torch.empty((Q, n_splits, k), device=dev)
        part_i = torch.empty((Q, n_splits, k), dtype=torch.int32, device=dev)
        d = torch.empty((Q, k), device=dev)
        i = torch.empty((Q, k), dtype=torch.int32, device=dev)
        bound = ops.seed_bound(queries, corpus, k)
        _build.check("timeline", read(None, n))
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        _build.check("ann_topk", fn(
            queries.data_ptr(), corpus.data_ptr(),
            None if bound is None else bound.data_ptr(), part_d.data_ptr(),
            part_i.data_ptr(), d.data_ptr(), i.data_ptr(), Q, N, D, k,
            n_splits, per, stream))
        torch.cuda.synchronize()
        buf = np.zeros((n, STAMPS), np.int64)
        _build.check("timeline", read(buf.ctypes.data, n))
        cyc, t0, t1 = (buf[:, len(PHASES) + j] for j in (3, 4, 5))
        mhz = float(np.median(cyc / np.maximum(t1 - t0, 1) * 1e3))
        med = np.median(buf, axis=0)
        out["k"][k] = {
            "sm_clock_mhz": round(mhz, 1),
            "first_start_to_last_exit_us": round(
                float(t1.max() - t0.min()) / 1e3, 3),
            **{p: round(float(med[j]) / mhz, 3)
               for j, p in enumerate(PHASES)},
            **{c: int(med[len(PHASES) + j]) for j, c in enumerate(COUNTS)}}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, nargs="+", default=[1, 64, 256])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("timeline: needs a CUDA device")
    from ...ann.corpus import make_corpus, make_queries
    full, red, _ = make_corpus(262_144, 1024, 128, seed=0)
    q = make_queries(full, 1024)[:, :128].copy()
    del full
    print(json.dumps(run(torch.from_numpy(q).cuda(),
                         torch.from_numpy(red).cuda(), args.k)))


if __name__ == "__main__":
    main()
