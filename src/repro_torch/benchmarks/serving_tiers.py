"""Fourth-tier benchmark: gpu_flash + pool arms vs the 3-tier baseline.

Replays two declared scenario packs through four arms of the same
platform spec and prices each run with the fleet-shared normalized
rates (see `repro_torch.serving.tiers`):

  * ``moe_scan``  — MoE-heavy decodes + a cold-scan tenant whose think
    gaps sit beyond every DRAM band. Its resumes pay the flash path in
    every arm, so the BaM-style ``gpu_flash`` arm wins by dropping the
    host-CPU per-IO rent and servicing at the saturated queue rung.
  * ``diurnal``   — two tenant populations with staggered peaks and
    think gaps inside the pool band `[tau_be, tau_pool)`. The
    fleet-shared ``pool`` arm wins: discounted DRAM-class residency
    beats a flash re-read for exactly that interval range.

Acceptance (asserted by tests, reported here): each new tier shape
strictly beats the baseline on modeled $/token at equal-or-lower
per-token stall in its scenario, and the baseline platform's
`advise_tiers` four-arm comparison recommends a measured winner.

The twin of the reference's `benchmarks/serving_tiers.py`: the same
flags plus `--device` (where every arm's engine decodes, through the
serving kernels on CUDA, the default, or their plain versions on the
CPU, and where the economic gates keep their reuse sketch). The JSON is
deterministic (virtual clock, seeded draws, greedy decode): the JSON on
stdout and the `--out` file are byte-identical across runs, across
devices, and to the reference script's; the table on stderr matches it
line for line.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_tiers --smoke
  PYTHONPATH=src python -m repro_torch.benchmarks.serving_tiers \\
      --device cpu --out tiers.json
"""
import argparse
import dataclasses
import pathlib
import sys

from ..obs import write_bench_json
from ..serving.tiers import (ARM_ORDER, default_pool_decl, run_tiers_bench,
                             scenario_packs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool-blobs", type=int, default=64,
                    help="pool capacity in KV-blob units")
    ap.add_argument("--rent-factor", type=float, default=0.25,
                    help="pool rent as a fraction of local DRAM rent")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="pinned small packs for the determinism check")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the engines decode and the gates keep "
                         "their reuse sketch (the JSON does not depend "
                         "on it)")
    args = ap.parse_args(argv)

    pool = dataclasses.replace(
        default_pool_decl(blobs=args.pool_blobs),
        rent_factor=args.rent_factor)
    packs = scenario_packs(smoke=args.smoke)
    out = run_tiers_bench(packs, pool=pool, max_slots=args.max_slots,
                          device=args.device)
    write_bench_json(out, args.out)

    w = sys.stderr.write
    for scen in packs:
        cell = out[scen]
        w(f"\n== {scen}  tau_be={cell['baseline']['tau_be']:.3f} s"
          f"  tau_pool={cell['pool'].get('tau_pool', float('nan')):.3f} s\n")
        w(f"   {'arm':10s} {'$/token':>14s} {'stall/token':>14s} "
          f"{'win':>5s}\n")
        for arm in ARM_ORDER:
            k = cell[arm]["costs"]
            win = "-" if arm == "baseline" else \
                ("yes" if cell["wins"][arm] else "no")
            w(f"   {arm:10s} {k['per_token']:14.8g} "
              f"{k['per_token_stall']:14.8g} {win:>5s}\n")
        w(f"   advisor recommends: {cell['advice']['recommended_arm']}"
          f"  (agrees with measurement: {cell['advice_agreement']})\n")
    w(f"\ngpu_flash wins somewhere: {out['gpu_flash_wins_somewhere']}\n"
      f"pool wins somewhere:      {out['pool_wins_somewhere']}\n")


if __name__ == "__main__":
    main()
