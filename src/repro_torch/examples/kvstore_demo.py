"""SSD-resident blocked-Cuckoo KV store (case study 1), runnable.

Fills a table to the paper's 0.7 load factor, serves GETs through the
`cuckoo_probe` kernel, exercises the WAL/coalescing write path, and
prints the modeled Fig. 8 platform throughput.

The twin of the reference's `examples/kvstore_demo.py`: the same store,
seed and printed lines, plus `--device` (where the table's copy is
probed: the kernel on CUDA, the default, or its plain version on the
CPU). The GET line names which ran, as the wrapper's launch count saw
it, and its time is read after the card has finished.

  PYTHONPATH=src python -m repro_torch.examples.kvstore_demo [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from .._device import device_name, resolve_device
from ..kernels.cuckoo_probe import cuckoo_probe
from ..kvstore.cuckoo import BlockedCuckooStore
from ..kvstore.model import (KvWorkload, achievable_throughput,
                             cpu_sn_platform, gpu_nr_platform,
                             gpu_sn_platform)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the table's copy is probed (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    nb, slots = 8192, 8
    st = BlockedCuckooStore(n_buckets=nb, slots=slots,
                            dram_cache_items=1024, wal_limit=128,
                            device=dev)
    rng = np.random.default_rng(0)
    n = int(nb * slots * 0.7)
    keys = rng.choice(np.arange(1, 10**8), size=n, replace=False)
    t0 = time.time()
    for k in keys:
        st.put(int(k), int(k) % 99991)
    st.flush()
    print(f"[store] {n} items inserted at load {st.load_factor():.3f} "
          f"in {time.time()-t0:.1f}s; E[chain]={st.expected_chain_len():.4f}"
          f" observed relocations={st.stats.relocations}")

    # batched GETs through the probe kernel
    probe = keys[rng.integers(0, n, 4096)].astype(np.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launched = cuckoo_probe.launches
    t0 = time.time()
    found, vals = st.get_batch(probe)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    # what ran, as the wrapper counted it: the kernel if it launched
    ran = ("cuckoo_probe kernel" if cuckoo_probe.launches > launched
           else "cuckoo_probe's plain version")
    ok = int((vals[found.astype(bool)]
              == probe[found.astype(bool)] % 99991).sum())
    print(f"[store] batched GET x{len(probe)}: {found.sum()} found, "
          f"{ok} values correct, {dt*1e3:.0f}ms "
          f"({ran} on {device_name(dev)}; ~1.5 block reads/GET)")
    print(f"[store] stats: {st.stats}")

    print("\n[model] paper Fig. 8 (5TB store, 80B items, 4 SSDs):")
    wl = KvWorkload(get_frac=0.9, sigma=1.2)
    for plat in (gpu_sn_platform(), cpu_sn_platform(), gpu_nr_platform()):
        r = achievable_throughput(plat, wl, 256e9)
        print(f"  {plat.name:7s}: {r['throughput']/1e6:7.1f} Mops/s "
              f"(limiter: {r['limiter']}, cache hit {r['hit_rate']:.2f})")
    print("  -> GPU+Storage-Next reaches in-memory-class throughput "
          "(FASTER-level) from flash")


if __name__ == "__main__":
    main()
