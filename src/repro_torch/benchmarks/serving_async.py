"""Async-prefetch serving benchmark (paper §VII-A session workload).

Compares modeled per-token stall of a synchronous KV restore against the
async queueing-aware runtime's prefetch path, on the same multi-turn
session workload and virtual clock. The twin of the reference's
`benchmarks/serving_async.py`: same flags, same table, and an `--out`
JSON that is byte-identical to the reference's.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_async
"""
import argparse
import pathlib

from ..obs import write_bench_json
from ..serving.bench import compare


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kv-mib", type=float, default=2.0)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--step-time-ms", type=float, default=2.0)
    ap.add_argument("--lead", type=int, default=8,
                    help="prefetch lead in decode steps")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="write the canonical JSON report here "
                         "(stdout keeps the human table)")
    args = ap.parse_args(argv)

    params = dict(n_sessions=args.sessions, rounds=args.rounds,
                  kv_bytes=int(args.kv_mib * 2**20),
                  decode_steps=args.decode_steps,
                  step_time=args.step_time_ms * 1e-3, lead=args.lead)
    r = compare(**params)
    if args.out:
        write_bench_json({"params": params, **r}, out=args.out,
                         echo=False)
    print(f"{'mode':8s} {'stall/token':>12s} {'total stall':>12s} "
          f"{'makespan':>10s} {'pf hit':>7s} {'pf late':>8s} {'MuM':>5s}")
    for mode in ("sync", "async"):
        d = r[mode]
        print(f"{mode:8s} {d['per_token_stall']*1e6:10.1f}us "
              f"{d['total_stall']*1e3:10.2f}ms "
              f"{d['makespan']*1e3:8.1f}ms "
              f"{int(d['prefetch_hits']):7d} {int(d['prefetch_late']):8d} "
              f"{int(d['miss_under_miss']):5d}")
    speedup = r["sync"]["per_token_stall"] / max(
        r["async"]["per_token_stall"], 1e-12)
    print(f"\nasync prefetch cuts modeled per-token stall "
          f"{speedup:.1f}x on the multi-turn session workload")


if __name__ == "__main__":
    main()
