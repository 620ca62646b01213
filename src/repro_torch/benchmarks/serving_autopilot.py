"""Autopilot serving benchmark: break-even admission vs static placement.

Replays four scenario traces (Zipf, scan-flood, diurnal hotspot shift,
bursty multi-tenant) against a capacity-bound TieredStore under three
policies — the EconomicGate (tracked reuse vs calibrated break-even),
always-DRAM (LRU-ish capacity pressure) and always-flash — and reports
modeled $/token (DRAM rent + DRAM wire + flash IO + host CPU + stalled
accelerator time, in the paper's normalized units) plus per-token
stall. The acceptance criterion per scenario: the gate's $/token must
not exceed the best static baseline's at equal-or-lower per-token
stall.

`--autoscale` runs the closed provisioning loop instead: a one-host
platform on the diurnal trace where `Platform.autoscale` lets the
`ProvisionAdvisor` drive `add_host`/`remove_host` (under the rebalance
pacer), priced against a static fleet provisioned for the peak.

`--failover` runs the kill-a-host-at-diurnal-peak scenario instead:
replication arms r in {1,2,3} replay the same trace on a four-host
fleet, the busiest host dies unplanned at the peak, the repair loop
re-replicates under the rebalance pacer, and checkpointed sessions fail
over to surviving hosts.

`--trace` attaches the causal tracer to the scenario suite and writes
the Perfetto/Chrome trace_event export (open at ui.perfetto.dev).

The twin of the reference's `benchmarks/serving_autopilot.py`: the same
flags plus `--device` (where the economic gates keep their reuse
sketch: the reuse_sketch kernel on CUDA, the default, or its plain
version on the CPU). Everything runs on a VirtualClock with seeded
traces, so the JSON on stdout, the `--out` file and the `--trace`
export are byte-identical across runs, across devices, and to the
reference script's; the tables on stderr match it line for line.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_autopilot --smoke
  PYTHONPATH=src python -m repro_torch.benchmarks.serving_autopilot \\
      --device cpu --autoscale --out autoscale.json
"""
import argparse
import pathlib
import sys

from ..autopilot.bench import run_suite
from ..autopilot.traces import SCENARIOS
from ..obs import write_bench_json


def run_autoscale(args):
    from ..platform import run_autoscale_bench
    report = run_autoscale_bench(
        scenario=args.autoscale_scenario,
        n_steps=120 if args.smoke else args.steps,
        step_time=args.step_time_ms * 1e-3,
        l_blk=int(args.l_blk_kib * 1024),
        alpha_accel=args.alpha_accel, seed=args.seed, device=args.device)
    write_bench_json(report, out=args.out)

    a, s = report["autoscaled"], report["static"]
    print(f"\n{'arm':>10s} {'hosts':>11s} {'$/tok':>10s} "
          f"{'stall us/tok':>13s} {'host-sec':>9s}", file=sys.stderr)
    for name, r in (("autoscaled", a), ("static", s)):
        span = (f"{int(r['hosts_start'])}->{int(r['hosts_peak'])}->"
                f"{int(r['hosts_final'])}")
        print(f"{name:>10s} {span:>11s} {r['cost_per_token']:10.6f} "
              f"{r['per_token_stall']*1e6:13.1f} "
              f"{r['host_seconds']:9.1f}", file=sys.stderr)
    for d in a.get("decisions", []):
        print(f"  t={int(d['step']):3d} {d['action']:>6s} -> "
              f"{int(d['n_hosts'])} host(s) (advisor: "
              f"{int(d['recommended'])}): {d['reason']}", file=sys.stderr)
    print(f"\nautoscale wins on $/token: {report['autoscale_wins']} "
          f"(x{report['cost_ratio_vs_static']:.3f} vs static); final "
          f"fleet within one host of advice: "
          f"{report['final_within_one_of_advice']}", file=sys.stderr)


def run_failover(args):
    from ..platform import run_failover_bench
    report = run_failover_bench(
        scenario=args.autoscale_scenario,
        n_steps=100 if args.smoke else args.steps,
        n_sessions=8 if args.smoke else 12,
        step_time=args.step_time_ms * 1e-3,
        l_blk=int(args.l_blk_kib * 1024),
        alpha_accel=args.alpha_accel, seed=args.seed, device=args.device)
    write_bench_json(report, out=args.out)

    print(f"\n{'arm':>4s} {'$/tok':>10s} {'stall us/tok':>13s} "
          f"{'lost keys':>9s} {'lost sess':>9s} {'resumed':>8s} "
          f"{'recovery s':>10s}", file=sys.stderr)
    rec = int(report["recommended_replicas"])
    for r, arm in sorted(report["arms"].items()):
        tag = "*" if int(r) == rec else " "
        print(f" r={r}{tag} {arm['cost_per_token']:10.6f} "
              f"{arm['per_token_stall']*1e6:13.1f} "
              f"{int(arm['committed_keys_lost']):9d} "
              f"{int(arm['sessions_lost']):9d} "
              f"{int(arm['sessions_resumed']):8d} "
              f"{arm['recovery_seconds']:10.4f}", file=sys.stderr)
    print(f"\nadvisor recommends r={rec} "
          f"(mttf={report['params']['mttf']:.0f}s); beats both "
          f"alternatives on $/token: {report['recommended_wins']}; "
          f"zero committed loss (r>=2): "
          f"{report['zero_committed_loss_replicated']}; all sessions "
          f"resume (r>=2): {report['all_sessions_resume_replicated']}",
          file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", default=",".join(SCENARIOS),
                    help="comma-separated scenario names")
    ap.add_argument("--steps", type=int, default=240,
                    help="trace length in decode steps")
    ap.add_argument("--step-time-ms", type=float, default=250.0,
                    help="modeled compute per step (ms)")
    ap.add_argument("--l-blk-kib", type=float, default=128.0,
                    help="object size (KiB)")
    ap.add_argument("--dram-frac", type=float, default=0.35,
                    help="DRAM capacity as a fraction of the recurring "
                         "working set")
    ap.add_argument("--alpha-accel", type=float, default=4.0,
                    help="normalized rent of the serving resource a "
                         "demand miss idles ($/s, NAND die == 1 — the "
                         "same units as alpha_core); enters both the "
                         "cost model and the gate's break-even")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="short trace (120 steps) for the CI "
                         "determinism gate")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the closed provisioning loop on the "
                         "diurnal trace (advisor-driven add/remove "
                         "host) vs a peak-provisioned static fleet")
    ap.add_argument("--failover", action="store_true",
                    help="run the kill-a-host-at-diurnal-peak scenario "
                         "(replication arms r=1..3, unplanned failure "
                         "+ paced repair + session failover) and the "
                         "advisor's replication recommendation")
    ap.add_argument("--autoscale-scenario", default="diurnal",
                    help="trace scenario for --autoscale/--failover")
    ap.add_argument("--trace", action="store_true",
                    help="attach the causal tracer to the scenario "
                         "suite and export a Perfetto/Chrome "
                         "trace_event JSON (deterministic bytes)")
    ap.add_argument("--trace-out", type=pathlib.Path, default=None,
                    help="trace export path (default "
                         "autopilot_trace.json)")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the JSON report here")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the economic gates keep their reuse "
                         "sketch (the record does not depend on it)")
    args = ap.parse_args(argv)

    if args.autoscale:
        return run_autoscale(args)
    if args.failover:
        return run_failover(args)

    scenarios = [s for s in str(args.scenarios).split(",") if s]
    n_steps = 120 if args.smoke else args.steps
    obs = None
    if args.trace:
        from ..obs import Observability
        obs = Observability(trace=True)
    report = run_suite(
        scenarios, n_steps=n_steps,
        step_time=args.step_time_ms * 1e-3,
        l_blk=int(args.l_blk_kib * 1024), dram_frac=args.dram_frac,
        alpha_accel=args.alpha_accel, seed=args.seed, obs=obs,
        device=args.device)
    report["params"] = {
        "scenarios": scenarios, "n_steps": n_steps,
        "step_time_ms": args.step_time_ms, "l_blk_kib": args.l_blk_kib,
        "dram_frac": args.dram_frac, "alpha_accel": args.alpha_accel,
        "seed": args.seed,
    }
    if obs is not None:
        report["stall_ledger"] = obs.ledger.as_dict()
    write_bench_json(report, out=args.out)

    if obs is not None:
        trace_out = args.trace_out or pathlib.Path("autopilot_trace.json")
        trace_out.write_text(obs.tracer.to_chrome_json() + "\n")
        print(f"\nperfetto trace: {trace_out} "
              f"({len(obs.tracer)} events, "
              f"{obs.tracer.dropped} dropped) — open at ui.perfetto.dev",
              file=sys.stderr)
        flame = obs.tracer.flamegraph().splitlines()
        for line in flame[:12]:
            print(f"  {line}", file=sys.stderr)
        if len(flame) > 12:
            print(f"  ... ({len(flame) - 12} more stacks)",
                  file=sys.stderr)

    print(f"\n{'scenario':>12s} {'mode':>9s} {'$/tok':>10s} "
          f"{'stall us/tok':>13s} {'rent':>7s} {'flashIO':>8s} "
          f"{'stall$':>7s}", file=sys.stderr)
    for cell in report["scenarios"]:
        for mode in ("economic", "dram", "flash"):
            r = cell["runs"][mode]
            tag = "*" if mode == cell["best_static"] else " "
            print(f"{cell['scenario']:>12s} {mode:>8s}{tag} "
                  f"{r['cost_per_token']:10.6f} "
                  f"{r['per_token_stall']*1e6:13.1f} "
                  f"{r['cost_dram_rent']:7.3f} {r['cost_flash_io']:8.3f} "
                  f"{r['cost_stall']:7.3f}", file=sys.stderr)
        print(f"{'':>12s} gate_wins={cell['gate_wins']} "
              f"(cost x{cell['cost_ratio_vs_best_static']:.2f} vs best "
              f"static)", file=sys.stderr)
    print(f"\ngate wins {report['wins']}/{report['cells']} scenarios "
          f"(acceptance: >= 3/4)", file=sys.stderr)


if __name__ == "__main__":
    main()
