"""Paper-table/figure reproductions (one function per artifact), the twin
of the reference's `benchmarks/paper_figs.py`.

Each function returns (rows, notes) where rows is a list of dicts; run.py
renders them. Acceptance anchors from the paper text are asserted here so
`python -m repro_torch.benchmarks.run` doubles as the reproduction check.

The analytics are host float64 and give the reference's rows. Fig. 10
takes a `device` (CUDA unless the caller names another) and runs exact
and two-stage search there (stage 1 through the `ann_topk` kernel on
CUDA).
"""
from __future__ import annotations

import dataclasses

from ..core import (CPU_DDR, CPU_PLATFORM, GPU_GDDR, GPU_PLATFORM,
                    LatencyTargets, LogNormalWorkload, SLC, PSLC, TLC,
                    analyze_platform, break_even, break_even_components,
                    iops_ssd_peak, normal_ssd, rho_max_for_targets,
                    storage_next_ssd, usable_iops)


# ---------------------------------------------------------------------------
# Fig. 3 — peak IOPS vs block size for SLC / pSLC / TLC
# ---------------------------------------------------------------------------

def fig3_iops():
    rows = []
    for nand in (SLC, PSLC, TLC):
        for sn in (True, False):
            ssd = storage_next_ssd(nand) if sn else normal_ssd(nand)
            for l in (512, 1024, 2048, 4096):
                iops = float(iops_ssd_peak(ssd, l, 9.0, 3.0))
                rows.append({"nand": nand.name,
                             "ssd": "storage-next" if sn else "normal",
                             "l_blk": l, "iops_M": iops / 1e6})
    # anchors: SLC storage-next ~57M @512B, ~11M @4KB (paper §III-C)
    slc512 = next(r for r in rows if r["nand"] == "SLC"
                  and r["ssd"] == "storage-next" and r["l_blk"] == 512)
    slc4k = next(r for r in rows if r["nand"] == "SLC"
                 and r["ssd"] == "storage-next" and r["l_blk"] == 4096)
    assert abs(slc512["iops_M"] - 57.4) < 1.5, slc512
    assert abs(slc4k["iops_M"] - 11.1) < 0.6, slc4k
    return rows, "anchors OK: SLC/SN 57.4M@512B, 11.1M@4KB"


# ---------------------------------------------------------------------------
# Table II — sensitivity of peak IOPS to N_CH / N_NAND / tau_CMD
# ---------------------------------------------------------------------------

def table2_sensitivity():
    settings = {
        "pessimistic": dict(n_ch=16, n_nand=3, tau_cmd=200e-9),
        "baseline": dict(n_ch=20, n_nand=4, tau_cmd=150e-9),
        "optimistic": dict(n_ch=24, n_nand=5, tau_cmd=100e-9),
    }
    expect = {"pessimistic": (39.4, 8.5), "baseline": (57.4, 11.1),
              "optimistic": (79.3, 13.8)}
    rows = []
    for name, kw in settings.items():
        ssd = storage_next_ssd(SLC, **kw)
        i512 = float(iops_ssd_peak(ssd, 512, 9.0, 3.0)) / 1e6
        i4k = float(iops_ssd_peak(ssd, 4096, 9.0, 3.0)) / 1e6
        rows.append({"setting": name, **kw, "iops512_M": i512,
                     "iops4k_M": i4k})
        e512, e4k = expect[name]
        assert abs(i512 - e512) / e512 < 0.05, (name, i512, e512)
        assert abs(i4k - e4k) / e4k < 0.06, (name, i4k, e4k)
    return rows, "all three Table II rows within 6% of paper values"


# ---------------------------------------------------------------------------
# Fig. 4 — break-even interval stacks
# ---------------------------------------------------------------------------

def fig4_breakeven():
    rows = []
    for host in (CPU_DDR, GPU_GDDR):
        for nand in (SLC, PSLC, TLC):
            for sn in (True, False):
                ssd = storage_next_ssd(nand) if sn else normal_ssd(nand)
                for l in (512, 1024, 2048, 4096):
                    comp = break_even_components(
                        host, l, ssd.cost,
                        float(iops_ssd_peak(ssd, l, 9.0, 3.0)))
                    rows.append({
                        "host": host.name, "nand": nand.name,
                        "ssd": "SN" if sn else "NR", "l_blk": l,
                        "t_host": float(comp["host"]),
                        "t_dram": float(comp["dram_bw"]),
                        "t_ssd": float(comp["ssd"]),
                        "tau_be": float(sum(comp.values()))})
    # anchors: ~34s CPU/SLC/SN@512B, ~10s @4KB, ~5s GPU/SLC/SN@512B (7x)
    cpu512 = next(r for r in rows if r["host"] == "CPU+DDR"
                  and r["nand"] == "SLC" and r["ssd"] == "SN"
                  and r["l_blk"] == 512)
    cpu4k = next(r for r in rows if r["host"] == "CPU+DDR"
                 and r["nand"] == "SLC" and r["ssd"] == "SN"
                 and r["l_blk"] == 4096)
    gpu512 = next(r for r in rows if r["host"] == "GPU+GDDR"
                  and r["nand"] == "SLC" and r["ssd"] == "SN"
                  and r["l_blk"] == 512)
    assert abs(cpu512["tau_be"] - 34) < 3, cpu512["tau_be"]
    assert abs(cpu4k["tau_be"] - 10) < 2, cpu4k["tau_be"]
    assert abs(gpu512["tau_be"] - 5) < 1, gpu512["tau_be"]
    assert 5.5 < cpu512["tau_be"] / gpu512["tau_be"] < 8.5
    return rows, ("anchors OK: 34s CPU / 5s GPU @512B (7x), "
                  "minutes->seconds reproduced")


# ---------------------------------------------------------------------------
# Fig. 5 + Table IV — constraint-aware break-even
# ---------------------------------------------------------------------------

def table4_rho_tiers():
    """Tail-latency tiers chosen to equalize rho_max across block sizes."""
    ssd = storage_next_ssd(SLC)
    tiers = {0.70: {512: 7e-6, 1024: 9e-6, 2048: 11e-6, 4096: 16e-6},
             0.80: {512: 9e-6, 1024: 11e-6, 2048: 15e-6, 4096: 23e-6},
             0.90: {512: 13e-6, 1024: 17e-6, 2048: 26e-6, 4096: 44e-6},
             0.99: {512: 85e-6, 1024: 135e-6, 2048: 230e-6, 4096: 418e-6}}
    rows = []
    for target_rho, taus in tiers.items():
        for l, tau in taus.items():
            peak = float(iops_ssd_peak(ssd, l, 9.0, 3.0))
            rho = float(rho_max_for_targets(
                LatencyTargets(tail=tau), ssd.n_ch, peak,
                ssd.nand.tau_sense))
            rows.append({"tier_rho": target_rho, "l_blk": l,
                         "tau_tail_us": tau * 1e6, "rho_max": rho})
            assert abs(rho - target_rho) < 0.13, (l, tau, rho, target_rho)
    return rows, "Table IV tau<->rho_max mapping holds (M/D/1 Kingman)"


def fig5_constraints():
    ssd = storage_next_ssd(SLC)
    rows = []
    # (a)(b): host budget sweep, no latency cap
    for host, budgets in ((CPU_DDR, (40e6, 60e6, 80e6, 100e6)),
                          (GPU_GDDR, (160e6, 240e6, 320e6, 400e6))):
        for b in budgets:
            for l in (512, 1024, 2048, 4096):
                peak = float(iops_ssd_peak(ssd, l, 9.0, 3.0))
                use = float(usable_iops(peak, 1.0, b, 4))
                tau = float(break_even(host, l, ssd.cost, use))
                rows.append({"panel": "host-sweep", "host": host.name,
                             "budget_M": b / 1e6, "l_blk": l,
                             "tau_be": tau})
    # anchors: CPU 512B 40M->100M: 83s->47s; 4KB stays ~10s
    a = next(r for r in rows if r["host"] == "CPU+DDR"
             and r["budget_M"] == 40 and r["l_blk"] == 512)
    b_ = next(r for r in rows if r["host"] == "CPU+DDR"
              and r["budget_M"] == 100 and r["l_blk"] == 512)
    c = next(r for r in rows if r["host"] == "CPU+DDR"
             and r["budget_M"] == 100 and r["l_blk"] == 4096)
    assert abs(a["tau_be"] - 83) < 6, a["tau_be"]
    assert abs(b_["tau_be"] - 47) < 5, b_["tau_be"]
    assert abs(c["tau_be"] - 10) < 2, c["tau_be"]
    # (c)(d): tail-tier sweep at fixed budgets
    tiers = {0.70: 7e-6, 0.80: 9e-6, 0.90: 13e-6, 0.99: 85e-6}
    gpu_taus = {}
    for host, budget in ((CPU_DDR, 100e6), (GPU_GDDR, 400e6)):
        for rho_t, tau_tail in tiers.items():
            peak = float(iops_ssd_peak(ssd, 512, 9.0, 3.0))
            rho = float(rho_max_for_targets(
                LatencyTargets(tail=tau_tail), ssd.n_ch, peak,
                ssd.nand.tau_sense))
            use = float(usable_iops(peak, rho, budget, 4))
            tau = float(break_even(host, 512, ssd.cost, use))
            rows.append({"panel": "tail-sweep", "host": host.name,
                         "tier_rho": rho_t, "l_blk": 512, "tau_be": tau})
            if host.name == "GPU+GDDR":
                gpu_taus[rho_t] = tau
    # anchor: GPU 512B, 7us -> 85us tail relaxation buys only ~1.5s
    delta = gpu_taus[0.70] - gpu_taus[0.99]
    assert 0.5 < delta < 2.5, delta
    return rows, (f"anchors OK: 83->47s CPU host sweep; tail relaxation "
                  f"worth only {delta:.1f}s on GPU (latency is secondary)")


# ---------------------------------------------------------------------------
# Fig. 6 — workload-aware provisioning
# ---------------------------------------------------------------------------

def fig6_provisioning():
    rows = []
    tiers = {512: 13e-6, 1024: 17e-6, 2048: 26e-6, 4096: 44e-6}
    for plat in (CPU_PLATFORM, GPU_PLATFORM):
        for sn in (True, False):
            ssd = storage_next_ssd(SLC) if sn else normal_ssd(SLC)
            p = dataclasses.replace(plat, ssd=ssd)
            for l in (512, 1024, 2048, 4096):
                wl = LogNormalWorkload.from_total_throughput(
                    throughput=200e9, sigma=1.0, n_blk=1e9, l_blk=l)
                rep = analyze_platform(
                    p, wl, l, LatencyTargets(tail=tiers[l]))
                rows.append({
                    "platform": plat.name, "ssd": "SN" if sn else "NR",
                    "l_blk": l,
                    "tau_be": rep.tau_break_even,
                    "T_B": rep.th.t_b, "T_S": rep.th.t_s,
                    "C_viable_GB": rep.c_dram_viable / 1e9,
                    "C_opt_GB": rep.c_dram_optimal / 1e9,
                    "bw_use_opt_GBs": rep.dram_bw_use_optimal / 1e9,
                    "verdict": rep.verdict})
    # qualitative anchors from §V-B
    gpu_sn_512 = next(r for r in rows if r["platform"] == "GPU+GDDR"
                      and r["ssd"] == "SN" and r["l_blk"] == 512)
    cpu_sn_512 = next(r for r in rows if r["platform"] == "CPU+DDR"
                      and r["ssd"] == "SN" and r["l_blk"] == 512)
    assert gpu_sn_512["T_B"] < 5 and gpu_sn_512["T_S"] < 5
    assert gpu_sn_512["C_viable_GB"] < cpu_sn_512["C_viable_GB"]
    assert gpu_sn_512["C_opt_GB"] < cpu_sn_512["C_opt_GB"]
    return rows, ("GPU+SN viable with far less DRAM than CPU+DDR; "
                  "T_v < 5s on GPU+SN (paper Fig. 6)")


# ---------------------------------------------------------------------------
# Fig. 7 — simulator vs analytic model
# ---------------------------------------------------------------------------

def fig7_sim_vs_model(quick: bool = True):
    from ..ssdsim import SimConfig, simulate_peak_iops
    from ..core.ssd_model import iops_ssd_peak as model_iops
    n_ops = 30_000 if quick else 120_000
    rows = []
    ssd = storage_next_ssd(SLC)
    # (a)+(b): rw-mix sweep
    for rf, expect_M in ((1.0, 82), (0.9, 68), (0.7, 52), (0.5, 34)):
        sim = simulate_peak_iops(SimConfig(ssd=ssd, l_blk=512,
                                           read_frac=rf), n_ops=n_ops)
        model = float(model_iops(ssd, 512,
                                 rf / max(1 - rf, 1e-9) if rf < 1
                                 else float("inf"), 3.0))
        rows.append({"panel": "rw-mix", "read_frac": rf,
                     "sim_iops_M": sim.iops / 1e6,
                     "model_iops_M": model / 1e6,
                     "paper_sim_M": expect_M})
        assert abs(sim.iops / 1e6 - expect_M) / expect_M < 0.25, \
            (rf, sim.iops / 1e6, expect_M)
    # (c): channel bandwidth sweep
    for bch, expect_M in ((3.6e9, 68), (4.8e9, 78), (5.6e9, 85)):
        ssd_b = storage_next_ssd(SLC, b_ch=bch)
        sim = simulate_peak_iops(SimConfig(ssd=ssd_b, l_blk=512,
                                           read_frac=0.9), n_ops=n_ops)
        rows.append({"panel": "channel-bw", "b_ch_GBs": bch / 1e9,
                     "sim_iops_M": sim.iops / 1e6,
                     "paper_sim_M": expect_M})
        assert abs(sim.iops / 1e6 - expect_M) / expect_M < 0.25
    # (d): BCH escalation sweep
    base = None
    for p_bch in (0.0, 0.01, 0.05):
        sim = simulate_peak_iops(SimConfig(ssd=ssd, l_blk=512,
                                           read_frac=0.9, p_bch=p_bch),
                                 n_ops=n_ops)
        base = base or sim.iops
        rows.append({"panel": "ecc", "p_bch": p_bch,
                     "sim_iops_M": sim.iops / 1e6,
                     "vs_errorfree": sim.iops / base})
    near = [r for r in rows if r["panel"] == "ecc" and r["p_bch"] == 0.01]
    # "reduce throughput modestly, remaining near the error-free plateau
    # for <=1% failure rate" — we observe ~7% at 1%
    assert near[0]["vs_errorfree"] > 0.90
    return rows, ("simulator reproduces Fig. 7 trends: 82/68/52/34M rw-mix,"
                  " channel-bw scaling, ECC plateau <=1%")


# ---------------------------------------------------------------------------
# Fig. 8 — KV store throughput
# ---------------------------------------------------------------------------

def fig8_kvstore():
    from ..kvstore.model import (KvWorkload, achievable_throughput,
                                     cpu_sn_platform, gpu_nr_platform,
                                     gpu_sn_platform)
    rows = []
    for plat in (gpu_sn_platform(), cpu_sn_platform(), gpu_nr_platform()):
        for gf in (1.0, 0.9, 0.7, 0.5):
            for sigma in (1.2, 0.4):
                for dram in (64e9, 256e9, 1024e9):
                    r = achievable_throughput(
                        plat, KvWorkload(get_frac=gf, sigma=sigma), dram)
                    rows.append({"platform": plat.name, "get_frac": gf,
                                 "sigma": sigma, "dram_GB": dram / 1e9,
                                 "Mops": r["throughput"] / 1e6,
                                 "limiter": r["limiter"],
                                 "hit": r["hit_rate"]})
    # anchors: GPU+SN read-heavy sustains 100+ Mops/s; CPU host-limited
    # below it; strong locality beats weak at equal capacity
    g = [r for r in rows if r["platform"] == "GPU+SN"
         and r["get_frac"] == 0.9 and r["sigma"] == 1.2
         and r["dram_GB"] == 256]
    c = [r for r in rows if r["platform"] == "CPU+SN"
         and r["get_frac"] == 0.9 and r["sigma"] == 1.2
         and r["dram_GB"] == 256]
    assert g[0]["Mops"] > 100, g
    assert c[0]["Mops"] < g[0]["Mops"]
    assert c[0]["limiter"] == "host-iops"
    weak = next(r for r in rows if r["platform"] == "GPU+SN"
                and r["get_frac"] == 0.9 and r["sigma"] == 0.4
                and r["dram_GB"] == 256)
    assert weak["Mops"] < g[0]["Mops"]
    return rows, ("GPU+SN sustains 100+ Mops/s read-heavy (in-memory-class);"
                  " CPU+SN host-IOPS-limited; locality spread reproduced")


# ---------------------------------------------------------------------------
# Fig. 10 — two-stage ANN search
# ---------------------------------------------------------------------------

def fig10_ann(quick: bool = True, device=None):
    from ..ann.corpus import make_corpus, make_queries
    from ..ann.model import (AnnWorkload, cpu_sn, gpu_nr, gpu_sn,
                             throughput_kqps)
    from ..ann.progressive import exact_topk, recall_at_k, search
    rows = []
    # recall validation on the MRL-like corpus (paper: >98%)
    n = 20000 if quick else 100000
    full, red, _ = make_corpus(n, 1024, 128)      # 4KB full / 512B reduced
    qs = make_queries(full, 200)
    truth = exact_topk(qs, full, 10, device=device)
    pred, stats = search(qs, red, full, k=10, promote=64, device=device)
    rec = recall_at_k(pred, truth)
    rows.append({"panel": "recall", "corpus": n, "recall@10": rec,
                 "promoted_frac": stats.stage2_reads / stats.stage1_reads})
    assert rec > 0.98, rec
    # throughput model across geometries (Fig. 10 a-d)
    for d_full, pf in ((2048, 0.05), (4096, 0.10), (6144, 0.15),
                       (8192, 0.20)):
        for plat in (gpu_sn(), cpu_sn(), gpu_nr()):
            for dram in (64e9, 256e9, 512e9):
                r = throughput_kqps(plat, AnnWorkload(
                    d_full_bytes=d_full, promote_frac=pf), dram)
                rows.append({"panel": f"512B->{d_full}B",
                             "platform": plat.name, "dram_GB": dram / 1e9,
                             "kqps": r["kqps"], "limiter": r["limiter"]})
    # anchors: GPU+SN tops every geometry; 2-3x+ over normal SSD;
    # rising with DRAM in light-promotion panels
    a = [r for r in rows if r.get("panel") == "512B->4096B"
         and r["platform"] == "GPU+SN"]
    nr = [r for r in rows if r.get("panel") == "512B->4096B"
          and r["platform"] == "GPU+NR"]
    assert a[-1]["kqps"] > a[0]["kqps"]
    assert min(x["kqps"] / y["kqps"] for x, y in zip(a, nr)) > 2.0
    return rows, (f"recall@10={rec:.3f} (>98%); GPU+SN {a[-1]['kqps']:.0f} "
                  "KQPS at 512GB, >=2-3x over normal SSD (DiskANN-class+)")


# ---------------------------------------------------------------------------
# Beyond-paper: TCO + CXL tier ladder (paper §VIII future work, built)
# ---------------------------------------------------------------------------

def tco_ladder():
    from ..core.tco import reference_tiers, tier_ladder, tco_break_even
    ssd = storage_next_ssd(SLC)
    rows = []
    for l in (512, 4096):
        ladder = tier_ladder(l, reference_tiers(ssd, l_blk=l))
        for name, tau in ladder:
            rows.append({"l_blk": l, "tier": name,
                         "stay_below_s": tau})
    ladder512 = tier_ladder(512, reference_tiers(ssd))
    names = [n for n, _ in ladder512]
    taus = [t for _, t in ladder512]
    assert names == ["HBM", "DRAM", "CXL-DRAM", "FLASH-SN"]
    assert all(a < b for a, b in zip(taus[:-1], taus[1:]))
    # OpEx direction finding
    tiers = reference_tiers(ssd)
    capex = tco_break_even(512, tiers[1], tiers[3], power_cost=0.0)
    full = tco_break_even(512, tiers[1], tiers[3])
    return rows, (
        f"4-tier ladder @512B: HBM<{taus[0]:.3f}s<DRAM<{taus[1]:.1f}s<"
        f"CXL<{taus[2]:.1f}s<flash; TCO (energy) lengthens the DRAM-flash "
        f"threshold {capex:.0f}s->{full:.0f}s: fetch energy dominates "
        "refresh power at $0.10/kWh")


# ---------------------------------------------------------------------------
# Beyond-paper: async-prefetch serving stall (queueing-aware runtime)
# ---------------------------------------------------------------------------

def serving_async(quick: bool = True):
    """Sync vs async KV restore on the multi-turn session workload —
    modeled per-token stall must drop under async prefetch."""
    from ..serving.bench import compare
    kw = dict(n_sessions=8, rounds=2, kv_bytes=1 << 20,
              decode_steps=16, step_time=2e-3, lead=8) if quick else \
        dict(n_sessions=32, rounds=4, kv_bytes=4 << 20,
             decode_steps=64, step_time=2e-3, lead=16)
    r = compare(**kw)
    rows = [{"mode": m,
             "stall_per_token_us": d["per_token_stall"] * 1e6,
             "total_stall_ms": d["total_stall"] * 1e3,
             "makespan_ms": d["makespan"] * 1e3,
             "prefetch_hits": int(d["prefetch_hits"]),
             "miss_under_miss": int(d["miss_under_miss"])}
            for m, d in r.items()]
    gain = r["sync"]["per_token_stall"] / max(
        r["async"]["per_token_stall"], 1e-12)
    assert r["async"]["per_token_stall"] < r["sync"]["per_token_stall"]
    return rows, (f"async prefetch cuts modeled per-token stall {gain:.1f}x"
                  " (queueing-aware flash service from ssdsim)")
