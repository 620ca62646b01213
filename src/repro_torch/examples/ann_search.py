"""Two-stage progressive ANN search (case study 2), runnable.

Builds an MRL-like corpus (full 4KB / reduced 512B vectors), runs the
two-stage search through the fused distance+top-k kernel (`ann_topk`),
measures recall vs exact brute force, and prints the modeled platform
KQPS.

The twin of the reference's `examples/ann_search.py`: the same flags,
corpus and printed lines, plus `--device` (where both searches run: the
kernel on CUDA, the default, or its plain version on the CPU). The wall
line names which ran, as the wrapper's launch count saw it, and each wall
is read after the card has finished.

  PYTHONPATH=src python -m repro_torch.examples.ann_search [--n 20000]
"""
import argparse
import time

import torch

from .._device import device_name, resolve_device
from ..ann.corpus import make_corpus, make_queries
from ..ann.model import AnnWorkload, cpu_sn, gpu_nr, gpu_sn, \
    throughput_kqps
from ..ann.progressive import exact_topk, recall_at_k, search
from ..kernels.ann_topk import ann_topk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--promote", type=int, default=64)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the searches run (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"[corpus] {args.n} vectors: full 1024-d (4KB), "
          f"reduced 128-d (512B) — MRL-style nested embeddings")
    full, red, _ = make_corpus(args.n, 1024, 128)
    qs = make_queries(full, args.queries)
    # the corpus and queries on the device, so the walls time the searches
    full, red, qs = (torch.from_numpy(a).to(dev) for a in (full, red, qs))

    sync()
    launched = ann_topk.launches
    t0 = time.time()
    truth = exact_topk(qs, full, 10, device=dev)
    sync()
    t_exact = time.time() - t0

    t0 = time.time()
    pred, stats = search(qs, red, full, k=10, promote=args.promote,
                         device=dev)
    sync()
    t_two = time.time() - t0
    # what ran, as the wrapper counted it: the kernel if it launched
    ran = ("ann_topk kernel" if ann_topk.launches > launched
           else "ann_topk's plain version")
    rec = recall_at_k(pred, truth)

    print(f"[search] recall@10 = {rec:.4f} (paper claims >98%)")
    print(f"[search] stage-2 re-ranks {args.promote} of {args.n} "
          f"candidates ({100*args.promote/args.n:.2f}%) — "
          f"{stats.stage2_reads} full-vector reads vs "
          f"{stats.stage1_reads} reduced reads")
    print(f"[search] wall: exact {t_exact:.2f}s vs two-stage {t_two:.2f}s "
          f"({ran} on {device_name(dev)})")

    print("\n[model] 8B-vector corpus, 4 SSDs (paper Fig. 10 geometry):")
    for plat in (gpu_sn(), cpu_sn(), gpu_nr()):
        row = [f"{throughput_kqps(plat, AnnWorkload(), d)['kqps']:6.1f}"
               for d in (64e9, 256e9, 512e9)]
        print(f"  {plat.name:7s} KQPS @ 64/256/512GB DRAM: "
              + " / ".join(row))


if __name__ == "__main__":
    main()
