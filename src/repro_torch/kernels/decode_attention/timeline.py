"""Per-block timeline of the decode-attention kernel on the card.

Builds `csrc/decode_attention.cu` once more with -DDEC_TIMELINE, whose
thread 0 of every block stamps the SM clock at the end of each phase,
runs one call at a decode shape (by default gemma-2b's: q [B,8,256],
k,v [B,1,1024,256] bf16, B = len(lengths)) behind a spin kernel, and gives
the phases, in us at the measured SM clock, of the block that exits
last (it merges the longest row) and the median phases of the blocks
that only write a partial. It reads clock stamps only and needs no
profiler. The build records the first RECORDED blocks of the grid
(kDecTimelineBlocks), rows (b, kv head) in order, all chunks of each:
past that, at a long cache, the timeline is that of the first rows.

    PYTHONPATH=src python3 -m repro_torch.kernels.decode_attention.timeline \
        [--lengths 613 148 548 230] [--reps 3] [--heads 8 --kv-heads 1 \
        --head-dim 256] [--max-len 1024]
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

PHASES = ("load", "scores", "softmax", "pv", "ticket", "weights", "merge")
STAMPS = 12          # kDecStamps in the source
RECORDED = 8192      # kDecTimelineBlocks in the source


def _library():
    so = _build.BUILD_DIR / f"decode_attention_timeline-{_build._digest()}.so"
    if not so.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DDEC_TIMELINE", "-I",
               str(_build.CSRC), "-o", str(so),
               str(_build.CSRC / "decode_attention.cu")]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.decode_attention_fwd
    fn.argtypes = _build.SIGNATURES["decode_attention"][1]
    fn.restype = ctypes.c_int
    read = lib.decode_attention_timeline
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    return fn, read


def run(lengths=(613, 148, 548, 230), reps: int = 3, heads: int = 8,
        kv_heads: int = 1, head_dim: int = 256, max_len: int = 1024) -> dict:
    """The timeline of `reps` calls (medians) at q [B,heads,head_dim],
    k,v [B,kv_heads,max_len,head_dim]; needs a CUDA device."""
    fn, read = _library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, KV, T, hd = len(lengths), heads, kv_heads, max_len, head_dim
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    # distinct caches, so a call finds its cache cold in L2 as a layer
    # does; one of a GB or more leaves under 5% of itself in the 50 MB L2
    n_caches = 8 if 4 * B * KV * T * hd < 1e9 else 1
    caches = [tuple(torch.randn(B, KV, T, hd, generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
              for _ in range(n_caches)]
    stream = torch.cuda.current_stream().cuda_stream
    tickets = torch.zeros(B * KV, dtype=torch.int32, device=dev)
    n = B * KV * -(-T // ops.CHUNK)

    def call(k, v):
        out = torch.empty(B, H, hd, dtype=torch.bfloat16, device=dev)
        scratch = torch.empty(ops.scratch_numel(B, KV, T, H // KV, hd),
                              device=dev)
        _build.check("decode_attention", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
            lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            tickets.data_ptr(), B, H, KV, T, hd, 0, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            0, 0, 0, 0, hd ** -0.5, 0.0, 1, 1, stream))

    partial, critical, span, mhz = [], [], [], []
    for rep in range(reps):
        for k, v in caches[:3]:
            call(k, v)
        torch.cuda.synchronize()
        _build.check("timeline", read(None, n))
        torch.cuda._sleep(20_000_000)
        call(*caches[(3 + rep % 5) % n_caches])
        torch.cuda.synchronize()
        buf = np.zeros((n, STAMPS), np.int64)
        _build.check("timeline", read(buf.ctypes.data, n))
        live = buf[buf[:, 1] != 0]
        for row in live:
            end = 8 if row[10] else 6
            mhz.append((row[end] - row[1]) / max(row[11] - row[0], 1) * 1e3)
            if not row[10]:
                partial.append(np.diff(row[1:7]))
        # the row that finishes last sets the kernel's length
        last = live[np.argmax(live[:, 11])]
        critical.append(np.diff(last[1:9]))
        span.append((last[11] - live[:, 0].min()) / 1e3)
    clock = float(np.median(mhz))

    def us(cycles):
        return dict(zip(PHASES, (round(float(c) / clock, 3)
                                 for c in np.median(cycles, axis=0))))

    return {"device": torch.cuda.get_device_name(0),
            "lengths": list(lengths), "heads": [H, KV, hd], "max_len": T,
            "blocks": n, "blocks_recorded": min(n, RECORDED),
            "sm_clock_mhz": round(clock, 1),
            "first_start_to_last_exit_us": round(float(np.median(span)), 3),
            "critical_block_us": us(critical),
            "partial_blocks_median_us": us(partial) if partial else None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lengths", type=int, nargs="+",
                    default=[613, 148, 548, 230])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=1)
    ap.add_argument("--head-dim", type=int, default=256)
    ap.add_argument("--max-len", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("timeline: needs a CUDA device")
    print(json.dumps(run(args.lengths, args.reps, args.heads,
                         args.kv_heads, args.head_dim, args.max_len)))


if __name__ == "__main__":
    main()
