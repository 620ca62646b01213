"""End-to-end serving example: batched requests through the decode engine
with five-minute-rule KV-cache tiering.

The twin of the reference's `examples/serve_tiered_kv.py`: serves the
reduced `--arch` config (a ported one; random weights from a seed) with
continuous batching, then pauses sessions and shows the tiering policy
placing their KV blocks (zamba2-7b's: its Mamba-2 state beside the
shared attention's KV; xlstm-350m's: its mLSTM and sLSTM states alone;
qwen2-vl-2b's: its M-RoPE backbone's KV, prompts of tokens alone as the
reference engine takes them; whisper-medium's: its self K/V beside its
cross-attention K/V of the encoder's rows, each prompt prefilled on zero
frames as the reference engine does) across DRAM/flash by observed reuse
interval, and resumes them transparently — including the async-prefetch
restore path overlapping the flash fetch with decode on the platform's
deterministic virtual clock. The modeled lines (tiers, stall, `[tier
stats]`, `[runtime queues]`) are the reference's.

The whole hierarchy is *declared*: a `HierarchySpec` (one host, static
seconds-scale thresholds, virtual clock, 5ms modeled decode step)
compiles into the platform, and the engine is a capability from its
facade — no clock/policy/store threading. It decodes on CUDA unless
`--device` names another device.

  PYTHONPATH=src python -m repro_torch.examples.serve_tiered_kv \
      [--arch deepseek-7b | mistral-nemo-12b | granite-20b |
       qwen3-moe-235b-a22b | llama4-maverick-400b-a17b | zamba2-7b |
       xlstm-350m | qwen2-vl-2b | whisper-medium]
      [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from .._device import device_name, resolve_device
from ..configs import PORTED, get_config
from ..models import model as M
from ..platform import HierarchySpec, HostDecl, Platform, PolicyDecl
from ..serving.engine import Request


def tier_sessions(eng, clock, r0, r1, step_time):
    """The session flow on two finished requests: pause both, bring the
    hot one straight back and pause it again, let the cold one cross
    tau_be, prefetch it three steps ahead and resume it. Returns the two
    first pauses' tiers, the hot one's second, and the cold one's tier
    before its prefetch."""
    eng.lengths[:] = 0
    eng.live[:] = False
    eng.slot_req.clear()
    eng.admit(r0)
    eng.admit(r1)
    tier_a = eng.pause(r0.rid)
    tier_b = eng.pause(r1.rid)
    # hot session comes back fast: promote on reuse
    eng.resume(r0.rid)
    tier_again = eng.pause(r0.rid)
    clock.advance(1.2)                # cold session crosses tau_be
    cold = eng.store.tier_of(("kv", r1.rid))
    # async restore: issue the prefetch, let modeled decode compute
    # overlap the flash fetch, then resume without stalling
    eng.prefetch(r1.rid)
    clock.advance(3 * step_time)      # three decode steps elsewhere
    eng.resume(r1.rid)
    return tier_a, tier_b, tier_again, cold


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=PORTED)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device to decode on (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    params = M.init_params(cfg, 0, device=dev)

    # the hierarchy, declared: one host, seconds-scale static
    # thresholds, deterministic virtual clock, 5ms modeled decode step
    spec = HierarchySpec(
        hosts=(HostDecl(),),
        policy=PolicyDecl.static(tau_hot=0.05, tau_be=1.0,
                                 ema_alpha=1.0),
        step_time=5e-3)
    platform = Platform.compile(spec, device=dev)
    clock = platform.clock
    eng = platform.engine(cfg, params, max_slots=4, max_len=64)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=f"session-{i}",
                    prompt=rng.integers(1, cfg.vocab, 8).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]

    t0 = time.time()
    done = eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"[serve] {len(done)}/{len(reqs)} requests, {toks} tokens in "
          f"{dt:.1f}s ({toks/dt:.1f} tok/s on {device_name(dev)}), "
          f"{eng.steps} batched decode steps")
    for r in done[:3]:
        print(f"  {r.rid}: {r.generated}")

    # --- session pause/resume through the tiered store -------------------
    print("\n[tiering] pausing two sessions; hot one re-accessed quickly,"
          " cold one left idle")
    r0, r1 = done[0], done[1]
    tier_a, tier_b, _, _ = tier_sessions(eng, clock, r0, r1,
                                         spec.step_time)
    print(f"  paused {r0.rid} -> {tier_a.name}, {r1.rid} -> {tier_b.name}")
    tier_hot = eng.store.tier_of(("kv", r0.rid))
    print(f"  after reuse pattern: {r0.rid} KV on "
          f"{tier_hot.name if tier_hot else 'engine'}, "
          f"{r1.rid} resumed with {eng.kv_stall_time*1e3:.2f}ms total "
          f"restore stall (prefetch overlapped)")
    print("\n[tier stats]")
    print(platform.report())
    print("\n[runtime queues]")
    print(eng.store.runtime.report())


if __name__ == "__main__":
    main()
