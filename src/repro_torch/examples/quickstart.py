"""Quickstart: the five-minute rule, recalibrated — in 60 seconds.

The twin of the reference's `examples/quickstart.py`: computes the
classical and calibrated break-even intervals, applies feasibility
constraints, runs the workload-aware platform advisor, derives a live
TieringPolicy, and finishes with the declarative API: one
`HierarchySpec` compiling into a running multi-host platform whose
economics are inputs, not plumbing — the complete RQ1->RQ4 pipeline.
The economic gates keep their reuse sketch on CUDA unless `--device`
names another device; every printed number is the reference's.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import pathlib

from ..core import (CPU_DDR, GPU_GDDR, CPU_PLATFORM, GPU_PLATFORM,
                    LatencyTargets, LogNormalWorkload, SLC,
                    analyze_platform, break_even_components,
                    classical_break_even, iops_ssd_peak,
                    storage_next_ssd, TieringPolicy)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the gates' reuse sketch "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    ssd = storage_next_ssd(SLC)
    l_blk = 512

    print("=" * 72)
    print("1. Classical (economics-only) five-minute rule, 2025 params")
    print("=" * 72)
    iops = float(iops_ssd_peak(ssd, l_blk, 9.0, 3.0))
    # DRAM $/byte normalized to NAND-die cost: 1 die / 3GB
    tau_classical = float(classical_break_even(
        l_blk, ssd.cost, iops, dram_cost_per_byte=1.0 / 3e9))
    print(f"  Storage-Next SSD: {iops/1e6:.1f}M IOPS @512B, "
          f"cost {ssd.cost:.0f} NAND-die-units")
    print(f"  classical break-even: {tau_classical:.1f}s "
          f"(Gray's 1987 answer was ~300s)")

    print()
    print("=" * 72)
    print("2. Calibrated break-even (host costs included, Eq. 1)")
    print("=" * 72)
    for host in (CPU_DDR, GPU_GDDR):
        comp = break_even_components(host, l_blk, ssd.cost, iops)
        total = float(sum(comp.values()))
        print(f"  {host.name:9s}: tau_be = {total:5.1f}s "
              f"(host {float(comp['host']):5.2f}s + dram "
              f"{float(comp['dram_bw']):5.2f}s + ssd "
              f"{float(comp['ssd']):5.2f}s)")
    print("  -> minutes (HDD era) -> tens of seconds (CPU) -> ~5s (GPU)")

    print()
    print("=" * 72)
    print("3. Workload-aware platform advisor (RQ3)")
    print("=" * 72)
    wl = LogNormalWorkload.from_total_throughput(
        throughput=200e9, sigma=1.0, n_blk=1e9, l_blk=l_blk)
    for plat in (CPU_PLATFORM, GPU_PLATFORM):
        rep = analyze_platform(plat, wl, l_blk,
                               LatencyTargets(tail=13e-6))
        print(f"  {rep.summary()}")

    print()
    print("=" * 72)
    print("4. Live tiering policy (drives KV-cache/expert/checkpoint tiers)")
    print("=" * 72)
    pol = TieringPolicy.from_platform(GPU_PLATFORM, l_blk,
                                      LatencyTargets(tail=13e-6))
    print(f"  HBM if reuse < {pol.tau_hot:.3f}s; DRAM if < "
          f"{pol.tau_be:.2f}s; else FLASH")
    for iv in (0.01, 1.0, 30.0):
        print(f"  object reused every {iv:5.2f}s -> "
              f"{pol.tier_for_interval(iv).name}")

    print()
    print("=" * 72)
    print("5. Declare the whole hierarchy (HierarchySpec -> Platform)")
    print("=" * 72)
    import numpy as np
    from ..platform import (HierarchySpec, HostDecl, Platform,
                            PolicyDecl, TierDecl)
    spec = HierarchySpec(
        # heterogeneous fleet: one big-DRAM host + three standard ones;
        # the compiled ring weights key ownership by DRAM capacity (2:1)
        hosts=(HostDecl(tiers={"dram": TierDecl(256e9, 45e9, 5e-7)}),
               HostDecl(count=3)),
        policy=PolicyDecl.economic(l_blk=128 << 10),
        class_priors={"kv": 2.0},       # sessions assumed ~2s reuse
    )
    platform = Platform.compile(spec, device=args.device)
    print(f"  compiled {platform.n_hosts} hosts, ring weights "
          f"{spec.resolved_weights()}, "
          f"tau_be={platform.policy(0).tau_be:.1f}s per-host gate")
    sess = platform.kv_session("user-42")
    sess.save(np.zeros(1 << 16, np.float32))        # gate picks the tier
    handle = sess.prefetch()                        # uniform async handle
    platform.clock.advance(0.01)
    handle.result()
    print(f"  kv_session save -> {sess.tier().name}, prefetch overlapped "
          f"-> done={handle.done()}")
    print(f"  spec round-trips: "
          f"{HierarchySpec.from_json(spec.to_json()) == spec}")
    advice = platform.advise()
    print(f"  advisor: hot set {advice.hot_bytes/2**20:.2f}MiB -> "
          f"{advice.recommended_hosts} host(s); platform.autoscale() "
          f"closes the loop")

    print()
    print("=" * 72)
    print("6. Observability: the Eq. 1 stall ledger + a Perfetto trace")
    print("=" * 72)
    import dataclasses
    from ..platform import ObservabilityDecl
    traced = Platform.compile(dataclasses.replace(
        spec, observability=ObservabilityDecl(trace=True)),
        device=args.device)
    sess = traced.kv_session("user-42")
    sess.save(np.zeros(1 << 16, np.float32))
    traced.clock.advance(5.0)               # think gap: reuse looks cold
    sess.resume()                           # synchronous restore stalls
    led = traced.ledger.as_dict()
    top = max((c for c in led if c not in ("total", "tenants")),
              key=lambda c: led[c])
    print(f"  every stalled second attributed: total "
          f"{led['total']*1e6:.1f}us, dominated by '{top}'")
    trace_path = pathlib.Path("quickstart_trace.json")
    trace_path.write_text(traced.tracer.to_chrome_json() + "\n")
    print(f"  causal trace: {trace_path} ({len(traced.tracer)} events) "
          f"-> open at https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
