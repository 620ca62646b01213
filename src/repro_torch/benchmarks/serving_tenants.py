"""Tenant-isolation benchmark: a declared scenario pack vs its SLOs.

Replays one `WorkloadDecl` pack — a premium chat tenant with a declared
p99 stall budget and `alpha_stall` rent, a batch tenant, and a
scan-flood adversary — through three arms of the same platform:

  * ``gated``        — `isolation="per-tenant"`: every tenant gets its
    own tau_be (SLO `alpha_stall` folded in) and its declared think-gap
    prior; the flood is priced straight to flash.
  * ``shared``       — the control: one fleet-wide threshold and class.
    The shared prior that welcomes premium's gaps welcomes the flood
    too; capacity pressure then demotes paused premium KV and its
    resumes pay the flash queue.
  * ``no_adversary`` — the shared gate without the scan tenant, showing
    the violation is the adversary's doing, not the shared gate's.

Acceptance (asserted by tests, reported here): premium's p99 per-token
restore stall meets its declared budget in ``gated`` and
``no_adversary``, and violates it in ``shared``.

The twin of the reference's `benchmarks/serving_tenants.py`: the same
flags plus `--device` (where every arm's engine decodes, through the
serving kernels on CUDA, the default, or their plain versions on the
CPU, and where the economic gates keep their reuse sketch). The JSON is
deterministic (virtual clock, seeded draws, greedy decode): the JSON on
stdout, the `--out` file and the `--trace` exports are byte-identical
across runs, across devices, and to the reference script's; the table
on stderr matches it line for line.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_tenants --smoke
  PYTHONPATH=src python -m repro_torch.benchmarks.serving_tenants \\
      --device cpu --scan-sessions 16 --dram-blobs 8 --out tenants.json
"""
import argparse
import dataclasses
import pathlib
import sys

from ..obs import write_bench_json
from ..serving.tenants import run_tenant_bench, tenant_pack


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--premium-sessions", type=int, default=4)
    ap.add_argument("--batch-sessions", type=int, default=3)
    ap.add_argument("--scan-sessions", type=int, default=10,
                    help="adversary flood size (paused blobs)")
    ap.add_argument("--dram-blobs", type=int, default=8,
                    help="host DRAM capacity in KV-blob units")
    ap.add_argument("--budget", type=float, default=2e-6,
                    help="premium p99 per-token stall budget (s/token)")
    ap.add_argument("--horizon", type=int, default=96)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="pinned small pack for the determinism check")
    ap.add_argument("--trace", action="store_true",
                    help="compile the arms with the causal tracer on "
                         "and export a Perfetto trace per arm")
    ap.add_argument("--trace-out", type=pathlib.Path, default=None,
                    help="trace export prefix (default tenants_trace; "
                         "writes <prefix>_<arm>.json)")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the engines decode and the gates keep "
                         "their reuse sketch (the JSON does not depend "
                         "on it)")
    args = ap.parse_args(argv)

    if args.smoke:
        spec = tenant_pack()            # the pinned default pack
    else:
        spec = tenant_pack(premium_sessions=args.premium_sessions,
                           batch_sessions=args.batch_sessions,
                           scan_sessions=args.scan_sessions,
                           dram_blobs=args.dram_blobs,
                           p99_stall_budget=args.budget,
                           horizon_steps=args.horizon, seed=args.seed)
    trace_sink = None
    if args.trace:
        from ..platform import ObservabilityDecl
        spec = dataclasses.replace(
            spec, observability=ObservabilityDecl(trace=True))
        trace_sink = {}
    report = run_tenant_bench(spec, max_slots=args.max_slots,
                              trace_sink=trace_sink, device=args.device)

    write_bench_json(report, out=args.out)

    if trace_sink:
        prefix = args.trace_out or pathlib.Path("tenants_trace")
        for arm, tracer in sorted(trace_sink.items()):
            p = prefix.with_name(f"{prefix.name}_{arm}.json")
            p.write_text(tracer.to_chrome_json() + "\n")
            print(f"perfetto trace ({arm}): {p} ({len(tracer)} events)",
                  file=sys.stderr)

    # ---- human report (stderr) ----------------------------------------
    print(f"\n{'arm':>13s} {'tenant':>8s} {'sessions':>8s} {'tokens':>7s} "
          f"{'p99 stall us/tok':>17s} {'resumes':>8s} {'misses':>7s}",
          file=sys.stderr)
    for arm in ("gated", "shared", "no_adversary"):
        cell = report[arm]["report"].get("tenants", {})
        for tenant, d in cell.items():
            print(f"{arm:>13s} {tenant:>8s} {d['sessions']:8d} "
                  f"{d['tokens']:7d} {d['p99_per_token_stall']*1e6:17.3f} "
                  f"{d['resumes']:8d} {d['deadline_misses']:7d}",
                  file=sys.stderr)
        taus = report[arm]["tau_be"]
        print(f"{'':>13s} tau_be: " + "  ".join(
            f"{k}={v:.2f}s" for k, v in sorted(taus.items())),
            file=sys.stderr)
    for tenant, v in report["verdicts"].items():
        print(f"\n{tenant}: budget={v['budget']*1e6:.2f}us/tok  "
              f"gated={v['gated_p99']*1e6:.3f} "
              f"shared={v['shared_p99']*1e6:.3f} "
              f"no_adversary={v['no_adversary_p99']*1e6:.3f}  "
              f"gated_ok={v['gated_meets_budget']} "
              f"shared_violates={v['shared_violates']} "
              f"causal={v['adversary_causal']}", file=sys.stderr)
    print(f"\nisolation effective: {report['isolation_effective']}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
