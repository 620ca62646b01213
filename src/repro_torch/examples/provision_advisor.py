"""Provisioning advisor — the paper's §V framework as a CLI.

Three modes:

* **analytic** (default): given an *assumed* log-normal workload (size,
  throughput, locality, block size, latency SLO) and a platform, report
  viability (T_B/T_S/T_C), the economics-optimal DRAM capacity, and an
  upgrade recommendation.
* **live** (`--trace <scenario>`): replay one of the autopilot trace
  scenarios (zipf, scan_flood, diurnal, multi_tenant) through a
  break-even-gated TieredStore and run the `autopilot.ProvisionAdvisor`
  on what the runtime *measured* — per-class reuse histograms, tier
  stats — instead of an assumed distribution.
* **four-arm tiers** (`--advise-tiers`, composes with `--trace`): feed
  the trace's reuse intervals to `advise_tiers` and print the Eq. 1
  four-arm comparison — 3-tier baseline vs `+gpu_flash` (BaM-style
  GPU-direct flash: no host-CPU per-IO rent) vs `+pool` (fleet
  far-memory at `--rent-factor` x DRAM rent for the
  `[tau_be, tau_pool)` band) vs both — and the cheapest shape.

The twin of the reference's `examples/provision_advisor.py`: every mode
and flag, the same printed lines, plus `--device` (where the live mode's
gates and the four-arm mode's tracker keep their reuse sketch: the
`reuse_sketch` kernel on CUDA, the default, or its plain version on the
CPU; the advice does not depend on it).

  PYTHONPATH=src python -m repro_torch.examples.provision_advisor \\
      --platform gpu --l-blk 512 --throughput-gbs 200 --tail-us 13
  PYTHONPATH=src python -m repro_torch.examples.provision_advisor \\
      --trace scan_flood
  PYTHONPATH=src python -m repro_torch.examples.provision_advisor \\
      --advise-tiers --trace diurnal --rent-factor 0.25
"""
import argparse
import sys

from .._device import resolve_device
from ..core import (CPU_PLATFORM, GPU_PLATFORM, LatencyTargets,
                    LogNormalWorkload, analyze_platform)
from ..core import units


def run_live(args, dev):
    from ..autopilot.bench import run_scenario
    from ..autopilot.traces import SCENARIOS
    if args.trace not in SCENARIOS:
        sys.exit(f"--trace must be one of {SCENARIOS}")
    rec = run_scenario(args.trace, "economic", n_steps=args.steps,
                       l_blk=int(args.obj_kib * 1024),
                       device=dev)
    print(f"scenario: {args.trace} ({int(rec['accesses'])} accesses, "
          f"{rec['horizon']:.1f}s modeled)")
    print(f"served at {rec['per_token_stall']*1e6:.1f}us/token stall, "
          f"modeled ${rec['cost_per_token']:.6f}/token "
          f"(normalized units)\n")
    adv = rec["advice"]
    print(f"  break-even tau  : {adv['tau_be']:.3f}s")
    print(f"  resident        : "
          f"{units.human_bytes(adv['resident_bytes'])}")
    print(f"  measured hot set: {units.human_bytes(adv['hot_bytes'])} "
          f"({adv['hot_fraction']*100:.0f}% of resident)")
    print(f"  provision DRAM  : "
          f"{units.human_bytes(adv['recommended_dram_bytes'])} across "
          f"{adv['recommended_hosts']} host(s)")
    print(f"  limit           : {adv['limit']}")
    for cls, row in adv["classes"].items():
        med = row["median_interval"]
        med = f"{med:.3f}s" if isinstance(med, float) else "unmeasured"
        print(f"    class {cls:12s} keys={int(row['keys']):5d} "
              f"median={med:>10s} hot={row['hot_fraction']*100:5.1f}%")
    print(f"\n  VERDICT: {adv['verdict']}")


def run_advise_tiers(args, dev):
    from ..autopilot.advisor import ProvisionAdvisor
    from ..autopilot.gate import default_classify
    from ..autopilot.reuse import ReuseTracker
    from ..autopilot.traces import SCENARIOS, generate
    from ..core import CPU_DDR, GPU_GDDR, storage_next_ssd

    scenario = args.trace or "diurnal"
    if scenario not in SCENARIOS:
        sys.exit(f"--trace must be one of {SCENARIOS}")
    l_blk = int(args.obj_kib * 1024)
    trace = generate(scenario, n_steps=args.steps, seed=0)
    tracker = ReuseTracker(device=dev)
    now = 0.0
    for step in trace.steps:
        for key in step:
            tracker.observe(key, default_classify(key), now)
        now += trace.step_time
    horizon = max(now, 1e-9)
    host = GPU_GDDR if args.platform == "gpu" else CPU_DDR
    advisor = ProvisionAdvisor(host, storage_next_ssd(), l_blk)
    advice = advisor.advise_tiers(
        tracker,
        access_rate=trace.accesses / horizon,
        resident_bytes=len(trace.distinct_keys()) * l_blk,
        pool_bw=args.pool_bw, pool_rtt=args.pool_rtt,
        rent_factor=args.rent_factor)
    print(f"scenario: {scenario} ({trace.accesses} accesses, "
          f"{horizon:.1f}s modeled) — four-arm hierarchy comparison")
    print(advice.report())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", choices=("cpu", "gpu"), default="gpu")
    ap.add_argument("--l-blk", type=int, default=512)
    ap.add_argument("--throughput-gbs", type=float, default=200.0)
    ap.add_argument("--n-blocks", type=float, default=1e9)
    ap.add_argument("--sigma", type=float, default=1.0,
                    help="access-interval lognormal spread (locality)")
    ap.add_argument("--tail-us", type=float, default=13.0)
    ap.add_argument("--dram-gb", type=float, default=0.0,
                    help="fixed DRAM capacity (0 = provision freely)")
    ap.add_argument("--trace", default=None,
                    help="live mode: replay this autopilot trace "
                         "scenario and advise from measured telemetry")
    ap.add_argument("--steps", type=int, default=240,
                    help="live mode: trace length in decode steps")
    ap.add_argument("--obj-kib", type=float, default=128.0,
                    help="live mode: object size in KiB (distinct from "
                         "--l-blk, which is the analytic mode's block "
                         "size in bytes)")
    ap.add_argument("--advise-tiers", action="store_true",
                    help="four-arm mode: price baseline / +gpu_flash / "
                         "+pool / both against the trace's measured "
                         "reuse intervals (composes with --trace; "
                         "default scenario: diurnal)")
    ap.add_argument("--pool-bw", type=float, default=40e9,
                    help="four-arm mode: pool fabric bandwidth, B/s")
    ap.add_argument("--pool-rtt", type=float, default=2e-6,
                    help="four-arm mode: pool fabric round-trip, s")
    ap.add_argument("--rent-factor", type=float, default=0.25,
                    help="four-arm mode: pool rent as a fraction of "
                         "local DRAM rent")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="live and four-arm modes: where the reuse "
                         "sketch is kept (the advice does not depend "
                         "on it; default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.advise_tiers:
        return run_advise_tiers(args, dev)
    if args.trace:
        return run_live(args, dev)

    plat = GPU_PLATFORM if args.platform == "gpu" else CPU_PLATFORM
    if args.dram_gb:
        import dataclasses
        plat = dataclasses.replace(plat, c_dram_total=args.dram_gb * 1e9)
    wl = LogNormalWorkload.from_total_throughput(
        throughput=args.throughput_gbs * 1e9, sigma=args.sigma,
        n_blk=args.n_blocks, l_blk=args.l_blk)
    rep = analyze_platform(plat, wl, args.l_blk,
                           LatencyTargets(tail=args.tail_us * 1e-6))

    print(f"workload: {units.human_bytes(wl.total_bytes)} across "
          f"{args.n_blocks:.0e} x {args.l_blk}B blocks, "
          f"{args.throughput_gbs:.0f} GB/s aggregate, sigma={args.sigma}")
    print(f"platform: {plat.name}, {plat.n_ssd} SSDs, host budget "
          f"{units.human_rate(plat.iops_proc)}, DRAM BW "
          f"{units.human_bytes(plat.b_dram_total)}/s")
    print()
    print(f"  usable SSD IOPS : {units.human_rate(rep.iops_ssd_usable)}"
          f"/SSD (rho_max={rep.rho_max:.2f}"
          + (", host-limited" if rep.host_limited else "") + ")")
    print(f"  break-even tau  : {units.human_time(rep.tau_break_even)}")
    print(f"  T_B / T_S / T_C : {units.human_time(rep.th.t_b)} / "
          f"{units.human_time(rep.th.t_s)} / "
          f"{units.human_time(rep.th.t_c)}")
    print(f"  DRAM for viable : {units.human_bytes(rep.c_dram_viable)}")
    print(f"  DRAM for optimal: {units.human_bytes(rep.c_dram_optimal)}")
    print(f"  DRAM BW at opt  : "
          f"{units.human_bytes(rep.dram_bw_use_optimal)}/s")
    print()
    print(f"  VERDICT: {rep.verdict}")
    print(f"  ADVICE : {rep.recommendation}")


if __name__ == "__main__":
    main()
