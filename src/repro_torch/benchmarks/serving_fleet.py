"""Fleet-scale sharded serving benchmark (multi-host tiering fabric).

Sweeps host count x session-popularity skew on the sharded
`ShardedTieredStore` fabric: sessions pause on one host and resume on
another, so KV restores compose the NIC transfer tier with the owner
host's calibrated flash queue. For every cell the sync restore path is
compared against async cross-host prefetch on the identical seeded
schedule, and the JSON trajectory (one record per cell, both modes +
stall speedup) is printed/written.

Elasticity (`--churn`): every cell additionally runs the identical
async schedule with a host join at mid-schedule (N -> N+1) — the fabric
streams the remapped ~1/(N+1) of resident keys as background rebalance
traffic on the shared clock — and reports the measured rebalance
fraction plus the rebalance tax (added per-token stall vs the no-churn
baseline). `--leave-turn` adds a host departure after the join.

`--lead p99` sizes prefetch leads per turn from the owner flash tier's
calibrated open-loop p99 (+ NIC leg) instead of a fixed step count;
`--locality` reroutes each resume to a host already holding the
session's KV replica.

Everything runs on one shared VirtualClock with fixed seeds, so the
emitted JSON is byte-identical across runs.

Declarative mode (`--spec fleet.json`, a `repro_torch.platform.HierarchySpec`
serialized via `spec.to_json()`): the fleet — per-host tier geometry,
capacity-weighted ring, policy, NIC/topology — compiles from the spec
instead of the `--hosts` keyword dialect. A homogeneous pinned-flash
spec reproduces the keyword path byte-for-byte; a heterogeneous spec
(one host with 2x DRAM) with `--kv-tier dram` shows the weighted ring's
stall win over `weighting="uniform"`.

The twin of the reference's `benchmarks/serving_fleet.py`: the same
flags plus `--device` (where a `--spec` fleet's economic gates keep
their reuse sketch: the reuse_sketch kernel on CUDA, the default, or its
plain version on the CPU; the keyword fleet holds nothing on a device).
The JSON on stdout and the `--out` file are byte-identical across
devices and to the reference script's; the table on stderr matches it
line for line.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_fleet --smoke
  PYTHONPATH=src python -m repro_torch.benchmarks.serving_fleet \\
      --device cpu --smoke --churn --out fleet.json
  PYTHONPATH=src python -m repro_torch.benchmarks.serving_fleet \\
      --hosts 2,4,8 --skew 0.0,1.2 --lead p99 --locality
  PYTHONPATH=src python -m repro_torch.benchmarks.serving_fleet \\
      --spec fleet_spec.json --kv-tier dram
"""
import argparse
import json
import pathlib
import sys

from ..core.policy import Tier
from ..obs import write_bench_json
from ..serving.bench import compare_churn, compare_fleet


def run_sweep(hosts, skews, *, n_sessions, rounds, kv_bytes, decode_steps,
              step_time, lead, seed, locality=False, churn=None,
              rebalance_rate=None, spec=None, kv_tier=Tier.FLASH,
              device=None):
    trajectory = []
    for h in hosts:
        for sk in skews:
            kw = dict(
                n_sessions=n_sessions, rounds=rounds,
                kv_bytes=kv_bytes, decode_steps=decode_steps,
                step_time=step_time, lead=lead, skew=sk, seed=seed,
                locality=locality, rebalance_rate=rebalance_rate,
                kv_tier=kv_tier, device=device)
            if spec is not None:
                kw["spec"] = spec
            else:
                kw["n_hosts"] = h
            cell = compare_fleet(**kw)
            if churn:
                # the cell's async record IS the no-churn baseline
                # (byte-identical runs) — don't simulate it a third time
                cell["churn"] = compare_churn(churn,
                                              baseline=cell["async"],
                                              **kw)
            trajectory.append({"hosts": h, "skew": sk, **cell})
    return trajectory


# defaults per mode; an explicitly-passed flag always overrides either.
# churn smoke uses more, smaller sessions so the measured rebalance
# fraction concentrates near the 1/(N+1) consistent-hash ideal instead
# of the high variance a handful of keys would show.
_FULL = dict(hosts="2,4,8", skew="0.0,1.2", sessions=16, rounds=2,
             kv_mib=1.0, decode_steps=16, step_time_ms=2.0, lead="8")
_SMOKE = dict(hosts="4", skew="0.0,1.2", sessions=8, rounds=2,
              kv_mib=0.5, decode_steps=8, step_time_ms=2.0, lead="6")
_SMOKE_CHURN = dict(_SMOKE, sessions=32, kv_mib=0.25)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", default=None,
                    help=f"comma-separated host counts "
                         f"(default {_FULL['hosts']}; smoke "
                         f"{_SMOKE['hosts']})")
    ap.add_argument("--skew", default=None,
                    help="comma-separated Zipf skews")
    ap.add_argument("--sessions", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--kv-mib", type=float, default=None)
    ap.add_argument("--decode-steps", type=int, default=None)
    ap.add_argument("--step-time-ms", type=float, default=None)
    ap.add_argument("--lead", default=None,
                    help="prefetch lead in decode steps, or 'p99' to "
                         "size it from the calibrated tail per turn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--locality", action="store_true",
                    help="route each resume to a host already holding "
                         "the session's KV replica")
    ap.add_argument("--churn", action="store_true",
                    help="per cell, also run the identical async "
                         "schedule with a host join at mid-schedule and "
                         "report the rebalance tax")
    ap.add_argument("--join-turn", type=int, default=None,
                    help="churn: turn before which the host joins "
                         "(default: mid-schedule)")
    ap.add_argument("--leave-turn", type=int, default=None,
                    help="churn: turn before which the newest host "
                         "leaves again")
    ap.add_argument("--pace-gbs", type=float, default=None,
                    help="churn: cap rebalance streams at this many "
                         "GB/s per source host (token bucket); default "
                         "unpaced")
    ap.add_argument("--smoke", action="store_true",
                    help="small fast defaults (4 hosts) for CI "
                         "determinism; explicit flags still apply")
    ap.add_argument("--spec", type=pathlib.Path, default=None,
                    help="declarative mode: compile the fleet from this "
                         "HierarchySpec JSON (spec.to_json()); --hosts "
                         "is ignored, the spec defines the fleet")
    ap.add_argument("--kv-tier", choices=("flash", "dram"),
                    default="flash",
                    help="pause/landing tier ask: flash measures the "
                         "restore path (default); dram exercises "
                         "capacity placement on heterogeneous specs")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the JSON report here")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where a --spec fleet's economic gates keep "
                         "their reuse sketch (the record does not "
                         "depend on it)")
    args = ap.parse_args(argv)

    # a join/leave turn implies churn mode — silently ignoring the flag
    # would report a no-churn sweep as an elasticity measurement
    args.churn = args.churn or args.join_turn is not None \
        or args.leave_turn is not None
    base = (_SMOKE_CHURN if args.churn else _SMOKE) if args.smoke \
        else _FULL

    def arg(name):
        v = getattr(args, name)
        return base[name] if v is None else v

    spec = None
    if args.spec is not None:
        from ..platform import HierarchySpec
        spec = HierarchySpec.from_json(args.spec.read_text())
        hosts = [spec.n_hosts]
    else:
        hosts = [int(x) for x in str(arg("hosts")).split(",")]
    skews = [float(x) for x in str(arg("skew")).split(",")]
    lead = str(arg("lead"))
    lead = lead if lead == "p99" else int(lead)
    churn = None
    if args.churn:
        n_turns = int(arg("rounds")) * int(arg("sessions"))
        join = n_turns // 2 if args.join_turn is None else args.join_turn
        # an event past the schedule would silently never fire and a
        # no-churn run would masquerade as an elasticity measurement
        if not 0 <= join < n_turns:
            ap.error(f"--join-turn must be in [0, {n_turns})")
        churn = {"join_turn": join}
        if args.leave_turn is not None:
            if not 0 <= args.leave_turn < n_turns:
                ap.error(f"--leave-turn must be in [0, {n_turns})")
            churn["leave_turn"] = args.leave_turn
    params = dict(n_sessions=arg("sessions"), rounds=arg("rounds"),
                  kv_bytes=int(arg("kv_mib") * 2**20),
                  decode_steps=arg("decode_steps"),
                  step_time=arg("step_time_ms") * 1e-3,
                  lead=lead, seed=args.seed, locality=args.locality,
                  churn=churn,
                  rebalance_rate=(args.pace_gbs * 1e9
                                  if args.pace_gbs else None))

    trajectory = run_sweep(hosts, skews, spec=spec,
                           kv_tier=Tier[args.kv_tier.upper()],
                           device=args.device, **params)
    report = {"params": {**params, "hosts": hosts, "skews": skews,
                         "kv_tier": args.kv_tier,
                         "spec": None if spec is None else
                         json.loads(spec.to_json())},
              "trajectory": trajectory}
    write_bench_json(report, out=args.out)

    print(f"\n{'hosts':>5s} {'skew':>5s} {'sync us/tok':>12s} "
          f"{'async us/tok':>13s} {'speedup':>8s} {'remote':>7s}",
          file=sys.stderr)
    for rec in trajectory:
        print(f"{rec['hosts']:5d} {rec['skew']:5.1f} "
              f"{rec['sync']['per_token_stall']*1e6:12.1f} "
              f"{rec['async']['per_token_stall']*1e6:13.1f} "
              f"{rec['stall_speedup']:8.1f} "
              f"{int(rec['async']['remote_fetches']):7d}",
              file=sys.stderr)
        if "churn" in rec:
            ch = rec["churn"]
            print(f"      churn: moved "
                  f"{ch['rebalance_bytes']/2**20:.2f}MiB "
                  f"({ch['rebalance_fraction']*100:.1f}% of resident, "
                  f"ideal {100.0/(rec['hosts']+1):.1f}%), stall x"
                  f"{ch['stall_ratio']:.2f} "
                  f"(+{ch['added_stall_per_token']*1e6:.2f}us/tok)",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
