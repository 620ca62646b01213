"""Benchmark harness: one artifact per paper table/figure, the twin of the
reference's `benchmarks/run.py`.
`python -m repro_torch.benchmarks.run [--full] [--skip-roofline] [--device cpu]`.

Each paper artifact asserts its acceptance anchors (numbers quoted in the
paper text), so a green run IS the reproduction check. `--device` is
where Fig. 10's search runs (CUDA by default: stage 1 through the
`ann_topk` kernel); the other artifacts are host analytics and the ssdsim
event simulator.

The dry-run roofline grid is not ported: without `--skip-roofline` the
harness prints one line saying so, and it is not counted as an artifact.
"""
from __future__ import annotations

import argparse
import sys
import time

from . import paper_figs as pf
from .._device import resolve_device


def _render(name, rows, note, show=6):
    print(f"\n=== {name} " + "=" * max(1, 66 - len(name)))
    if rows:
        keys = list(rows[0].keys())
        print(" | ".join(f"{k}" for k in keys))
        for r in rows[:show]:
            print(" | ".join(
                f"{v:.4g}" if isinstance(v, float) else str(v)
                for v in r.values()))
        if len(rows) > show:
            print(f"... ({len(rows)} rows total)")
    print(f"--> {note}")


def artifacts(quick: bool = True, device=None):
    """[(name, fn, kwargs)] of the eleven paper artifacts, in the order
    the harness runs them."""
    return [
        ("Fig. 3  SSD peak IOPS vs block size", pf.fig3_iops, {}),
        ("Table II  IOPS sensitivity (N_CH/N_NAND/tau_CMD)",
         pf.table2_sensitivity, {}),
        ("Fig. 4  break-even interval stacks", pf.fig4_breakeven, {}),
        ("Table IV  tail-latency tiers <-> rho_max", pf.table4_rho_tiers,
         {}),
        ("Fig. 5  constraint-aware break-even", pf.fig5_constraints, {}),
        ("Fig. 6  workload-aware provisioning", pf.fig6_provisioning, {}),
        ("Fig. 7  MQSim-Next vs analytic model", pf.fig7_sim_vs_model,
         {"quick": quick}),
        ("Fig. 8  SSD-resident KV store throughput", pf.fig8_kvstore, {}),
        ("Fig. 10  two-stage progressive ANN", pf.fig10_ann,
         {"quick": quick, "device": device}),
        ("Beyond-paper: TCO + CXL 4-tier ladder (paper §VIII)",
         pf.tco_ladder, {}),
        ("Beyond-paper: async-prefetch serving stall (runtime)",
         pf.serving_async, {"quick": quick}),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="long simulator runs (more ops)")
    ap.add_argument("--skip-roofline", action="store_true")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where Fig. 10's search runs (default: cuda)")
    args = ap.parse_args(argv)
    quick = not args.full
    device = resolve_device(args.device)

    t0 = time.time()
    arts = artifacts(quick, device)
    failures = []
    for name, fn, kw in arts:
        t = time.time()
        try:
            rows, note = fn(**kw)
            _render(name, rows, note)
            print(f"    [{time.time()-t:.1f}s]")
        except AssertionError as e:
            failures.append((name, e))
            print(f"\n=== {name}\n--> ANCHOR FAILED: {e}")
        except Exception as e:
            failures.append((name, e))
            print(f"\n=== {name}\n--> ERROR: {type(e).__name__}: {e}")

    if not args.skip_roofline:
        print("\nroofline report not ported: it waits for ROADMAP item 10")

    print(f"\n{'='*72}\n{len(arts)-len(failures)}/{len(arts)} "
          f"paper artifacts reproduced in {time.time()-t0:.0f}s")
    for name, e in failures:
        print(f"  FAILED: {name}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
