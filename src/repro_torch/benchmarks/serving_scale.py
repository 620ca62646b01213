"""Serving-scale benchmark: the vectorized control plane at 1M keys,
plus continuous-vs-lockstep scheduling on the autopilot traces.

Two parts, one JSON report:

  * `scale`: replays a seeded 1M-key / 100k-session trace through the
    batched control plane (`repro_torch.serving.scale`) —
    consistent-hash routing via `owner_batch`, array-ghost reuse
    tracking feeding one sketch update per step, vectorized break-even
    admission and array LRU, and queued flash misses priced off the
    `SsdQueueModel` depth ladder. The JSON carries only the *modeled*
    results and op counters (deterministic, byte-stable); the measured
    wall-clock cost per control-plane section prints to stderr,
    separately from modeled stall, because it is a property of the
    machine, not of the model.

  * `compare`: races `ContinuousScheduler` (per-step admission,
    pause-on-idle into the tiered store, prefetch-led resume) against
    the lock-step gang reference on multi-turn jobs derived from the
    autopilot trace scenarios. Both arms must emit byte-identical tokens (greedy decode); the race is
    modeled tokens/sec and per-token stall (KV restore stalls + idle
    slot-time in the same currency). Acceptance: continuous >= lockstep
    tokens/sec at equal-or-lower stall on every scenario.

The twin of the reference's `benchmarks/serving_scale.py`: the same
flags plus `--device` (where the replay's reuse sketch lives and the
model decodes: CUDA, the default, or the CPU). Its JSON equals the
reference script's byte for byte but for `compare.splice_traces`, the
reference's count of jit retraces: torch traces no programs, so the
twin leaves that key out. The stderr report matches line for line but
the measured wall-clock section.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_scale --smoke
  PYTHONPATH=src python -m repro_torch.benchmarks.serving_scale \\
      --device cpu --skip-compare --out scale.json
  PYTHONPATH=src python -m repro_torch.benchmarks.serving_scale \\
      --scenarios zipf,diurnal --out scale.json
"""
import argparse
import pathlib
import sys


def run_compare(scenarios, *, smoke: bool, seed: int, device=None,
                params=None):
    """Continuous against lock-step on each scenario's jobs, on fresh
    engines over one set of reduced gemma-2b weights: `params` on
    `device` (native float32 `init_params` with seed 0 when None)."""
    from .._device import resolve_device
    from ..configs import get_config
    from ..core.policy import TieringPolicy
    from ..models import model as M
    from ..runtime.clock import VirtualClock
    from ..runtime.tiers import TieredStore
    from ..serving import (DecodeEngine, compare_scheduling,
                           jobs_from_trace)

    device = resolve_device(device)
    cfg = get_config("gemma-2b", reduced=True)
    if params is None:
        params = M.init_params(cfg, 0, device=device)

    def engine_factory():
        clock = VirtualClock()
        # pinned-flash policy: every pause lands on flash, so resumes
        # pay (and prefetch hides) a real queued restore
        store = TieredStore(
            TieringPolicy(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0),
            clock=clock)
        return DecodeEngine(cfg, params, max_slots=4, max_len=64,
                            store=store, step_time=2e-3, device=device)

    n_jobs = 6 if smoke else 10
    horizon = 48 if smoke else 96
    out = {}
    for scen in scenarios:
        cell = compare_scheduling(
            engine_factory,
            lambda: jobs_from_trace(scen, n_jobs=n_jobs, n_turns=2,
                                    tokens_per_turn=5, vocab=cfg.vocab,
                                    horizon=horizon, seed=seed),
            pause_idle_steps=4)
        out[scen] = cell
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=1_000_000,
                    help="control-plane keyspace size")
    ap.add_argument("--sessions", type=int, default=100_000,
                    help="multi-turn sessions inside the keyspace")
    ap.add_argument("--steps", type=int, default=120,
                    help="fleet steps to replay")
    ap.add_argument("--accesses", type=int, default=50_000,
                    help="object accesses per step (sessions add their "
                         "turn arrivals on top)")
    ap.add_argument("--hosts", type=int, default=8)
    ap.add_argument("--tau-be", type=float, default=5.0,
                    help="break-even interval for the vectorized gate")
    ap.add_argument("--scenarios", default="zipf,diurnal",
                    help="autopilot trace scenarios for the "
                         "continuous-vs-lockstep race")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced sizes for the CI determinism gate")
    ap.add_argument("--skip-compare", action="store_true",
                    help="scale replay only (no model decode)")
    ap.add_argument("--no-metrics", action="store_true",
                    help="run the replay without the metrics plane "
                         "(CI compares wall time against the default "
                         "metrics-on run; modeled JSON is identical)")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the replay keeps its reuse sketch and the "
                         "model decodes (the JSON does not depend on it)")
    args = ap.parse_args(argv)

    from ..obs import Observability, write_bench_json
    from ..serving.scale import scale_replay

    if args.smoke:
        scale_kw = dict(n_keys=200_000, n_sessions=20_000, n_steps=30,
                        accesses_per_step=10_000, n_hosts=args.hosts,
                        tau_be=args.tau_be, seed=args.seed)
    else:
        scale_kw = dict(n_keys=args.keys, n_sessions=args.sessions,
                        n_steps=args.steps,
                        accesses_per_step=args.accesses,
                        n_hosts=args.hosts, tau_be=args.tau_be,
                        seed=args.seed)
    obs = None if args.no_metrics else Observability()
    record, timings = scale_replay(**scale_kw, obs=obs, device=args.device)

    report = {"scale": record, "params": {
        **{k: float(v) for k, v in scale_kw.items()},
        "smoke": float(args.smoke)}}

    if not args.skip_compare:
        scenarios = [s for s in str(args.scenarios).split(",") if s]
        if args.smoke:
            scenarios = scenarios[:1]
        report["compare"] = run_compare(scenarios, smoke=args.smoke,
                                        seed=args.seed, device=args.device)

    write_bench_json(report, out=args.out)

    # ---- human report (stderr): control-plane cost vs modeled stall ----
    print(f"\ncontrol plane (measured wall-clock, this machine — "
          f"reported separately from modeled stall):", file=sys.stderr)
    for k in ("digest", "routing", "tracking", "admission",
              "stall_pricing", "metrics"):
        print(f"  {k:>13s}: {timings[k]*1e3:9.1f} ms", file=sys.stderr)
    print(f"  {'throughput':>13s}: {timings['keys_per_sec']/1e6:9.2f} "
          f"M keys/s steady-state", file=sys.stderr)
    if obs is not None:
        print(f"  metrics plane on: "
              f"accesses={obs.metrics.counter('scale_accesses').value():.0f}"
              f" ledger flash_service="
              f"{obs.ledger.totals['flash_service']:.3f}s",
              file=sys.stderr)
    print(f"\nmodeled (deterministic, in the JSON): "
          f"hit_rate={record['hit_rate']:.3f} "
          f"per_access_stall={record['per_access_stall']*1e6:.1f}us "
          f"owner_imbalance={record['owner_imbalance']:.3f}",
          file=sys.stderr)

    if "compare" in report:
        print(f"\n{'scenario':>10s} {'arm':>11s} {'tok/s':>8s} "
              f"{'stall us/tok':>13s} {'idle slot-steps':>15s} "
              f"{'ticks':>6s}", file=sys.stderr)
        all_win = True
        for scen, cell in report["compare"].items():
            for arm in ("continuous", "lockstep"):
                r = cell[arm]
                print(f"{scen:>10s} {arm:>11s} {r['tokens_per_sec']:8.1f} "
                      f"{r['per_token_stall']*1e6:13.1f} "
                      f"{r['slot_idle_steps']:15d} {r['ticks']:6d}",
                      file=sys.stderr)
            print(f"{'':>10s} identical_tokens={cell['tokens_identical']} "
                  f"throughput x{cell['throughput_ratio']:.3f} "
                  f"stall x{cell['stall_ratio']:.3f} "
                  f"wins={cell['continuous_wins']}", file=sys.stderr)
            all_win = all_win and cell["continuous_wins"] \
                and cell["tokens_identical"]
        print(f"\ncontinuous >= lockstep everywhere: {all_win}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
