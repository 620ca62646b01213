"""Serving engine: continuous batching over a fixed slot grid, with
five-minute-rule-driven KV offload.

The engine owns a decode cache of `max_slots` sequences on the device.
Requests are prefilled into free slots and all live slots advance
together through one greedy decode step per token (per-slot fill indices —
slots at different positions coexist). Prefill runs through the
flash-attention kernel, decode through the decode-attention kernel, and
every norm through the rmsnorm kernel.

KV tiering (the paper's technique at work): when a request pauses, its
per-slot KV block is extracted and handed to the TieredStore keyed by
session id; the TieringPolicy's observed reuse interval vs the calibrated
break-even threshold decides whether it lands in host DRAM or flash. On
resume the block is re-inserted into a free slot.

Async KV restore: `prefetch` issues a session's KV fetch through
`TieredStore.get_async` before the slot is needed; each decode step
advances the store's injected clock by `step_time` (modeled decode
compute), so the flash transfer streams behind decode. `resume` then
blocks only on the unfinished remainder; the stall lands in
`kv_stall_time`.

Session durability: with `checkpoint_interval=N` every live slot re-puts
its KV blob and restart metadata every N decode steps (and on every
pause); `restore_checkpoint` resumes a session from that state.

The paused-KV blob is the reference package's: the cache leaves in
`jax.tree.leaves` order (dict keys sorted: groups before tail, `conv`
before `ssm`, `k` before `v`), each flattened as float32 and
concatenated. A slot is dim 1 of a group leaf [G,B,...] and dim 0 of a
tail leaf [B,...]. Its byte count prices the modeled fetch, so the two
packages see the same tiers and stalls.

When every sublayer is attention, FFN or MoE, prompt lengths are
right-padded to power-of-two buckets (the reference does so to compile
once per bucket; the port keeps it so that both packages write the same
pad-token KV into the slot and pause the same blob). The causal mask
keeps real positions pad-independent, and `prefill(last_index=...)`
returns the last *real* token's logits. A config with recurrent state
(Mamba-2, xLSTM's mLSTM and sLSTM) prefills at the prompt's exact length,
as the reference does: pads would advance the state. An xLSTM stack holds
no KV at all: its blob is its mLSTM matrix memories, sLSTM states and
conv windows, one size whatever the context (`C` before `conv`, then
`c`, `conv`, `h`, `m`, `n`, in the tree's order).

A "vlm" config (qwen2-vl-2b) is served as the reference engine serves
it: a request is its tokens alone, with no vision prefix, so its M-RoPE
positions are the index on all three streams, and its prompts are
bucketed as any attention config's.

A config with an encoder (whisper-medium) is served as the reference
engine serves it too: each admission prefills on zero frames [1,
n_frames, d_model] in the engine's dtype (the reference's stub audio
frontend feeds no audio), at the prompt's exact length (the reference
buckets only without an encoder), and a slot's cross-attention K/V of
the encoder's rows, one size at any context, travel with its self K/V
in the paused blob (in the tree's order, the cross sublayer's key after
the self-attention's).

A parked slot keeps its recurrent state: `step` passes the decoding
slots as `active`, and a recurrent sublayer writes its new state only
there. (The reference documents the same contract for `park`, but its
fixed-shape decode advances a parked slot's recurrent state on its stale
token; the port does not copy that.)

Multi-host mode (sharded fabric): pass `store=fabric.host_view(host)`
(what `repro_torch.platform.Platform.engine` does) and the engine's store
becomes that host's fabric view — KV blocks shard to their
consistent-hash owner host, and a session paused on one host can resume
on another: `export_session`/`import_session` hand the (tiny) session
metadata between engines while the KV block itself streams cross-host
through the fabric's NIC + remote-flash composition, behind decode when
`prefetch` is issued with enough lead. `locality_host` and
`route_session` send a resume to a host that already holds the blob.

Observability rides in on the store: with a tracer attached, admission,
pause, prefetch and resume are instants on the engine's track, stitched
into one causal flow per session.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.policy import TieringPolicy
from ..models import model as model_lib
from ..models.config import ModelConfig
from ..runtime.tiers import TieredStore


# eq=False: the generated dataclass __eq__ would compare the ndarray
# prompts elementwise — identity is the only meaningful equality here
@dataclasses.dataclass(eq=False)
class Request:
    rid: str
    prompt: np.ndarray            # [S] int32
    max_new: int = 16
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _leaves(tree, path=()):
    """(path, tensor) pairs in `jax.tree.leaves` order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _slot_of(leaf, path, slot: int):
    """One slot's view of a cache leaf at `path` ("groups"/... [G,B,...]:
    the slot is dim 1; "tail"/... [B,...]: dim 0)."""
    return leaf[:, slot] if path[0] == "groups" else leaf[slot]


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, params, *,
                 max_slots: int = 4, max_len: int = 256,
                 policy: Optional[TieringPolicy] = None,
                 store: Optional[TieredStore] = None,
                 clock=None, step_time: float = 0.0,
                 checkpoint_interval: int = 0,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.dtype = compute_dtype
        self.cache = model_lib.init_cache(cfg, max_slots, max_len,
                                          dtype=compute_dtype,
                                          device=self.device)
        self.lengths = np.zeros(max_slots, np.int32)    # filled positions
        self.live = np.zeros(max_slots, bool)
        # parked slots: live (KV resident, slot held) but not decoding
        self.active = np.zeros(max_slots, bool)
        self.last_token = np.zeros(max_slots, np.int32)  # decode inputs
        self.slot_req: Dict[int, Request] = {}
        # prompt-length bucketing is sound only when no cached sublayer
        # carries recurrent state (pads would advance it) and there is no
        # encoder (the reference's rule)
        self._bucket_prompts = cfg.encoder is None and all(
            spec.kind in ("attn", "ffn", "moe")
            for *_ignored, spec in cfg.sublayers())
        self.policy = policy or TieringPolicy(tau_hot=0.05, tau_be=5.0)
        # a fabric host view carries its host; a single-host store is host 0
        self.host = getattr(store, "host", 0)
        self.store = store or TieredStore(self.policy, clock=clock)
        self.clock = self.store.clock
        # observability rides in on the store (single-host or fabric
        # view): session lifecycle instants + causal flows join the
        # transfer spans the runtime already records
        self.obs = getattr(self.store, "obs", None)
        self.step_time = step_time      # modeled seconds of decode compute
        self.kv_stall_time = 0.0        # decode-visible restore stalls
        self._paused: Dict[str, tuple] = {}
        self._pending: Dict[str, object] = {}   # rid -> PendingFetch
        self.checkpoint_interval = int(checkpoint_interval)
        self._checkpoints: Dict[str, tuple] = {}
        self.steps = 0

    # -------------------------------------------------------- observability
    def _trace_session(self, name: str, rid: str, flow: str = "",
                       **args) -> None:
        """Session-lifecycle instant on this engine's track; `flow`
        ("s"/"t"/"f") stitches the event into the session's causal
        chain (admission -> prefetch -> fetch spans -> resume)."""
        if self.obs is None or self.obs.tracer is None:
            return
        t = self.obs.tracer
        track = t.track(f"host{self.host}", "engine")
        now = self.clock.now()
        t.instant(track, name, now, cat="session",
                  args={"rid": rid, **args})
        if flow == "s":
            t.flow_start(track, f"session:{rid}", now, ("session", rid))
        elif flow == "t":
            t.flow_step(track, f"session:{rid}", now, ("session", rid))
        elif flow == "f":
            t.flow_end(track, f"session:{rid}", now, ("session", rid))

    # ------------------------------------------------------------ admission
    def _free_slots(self) -> List[int]:
        return [i for i in range(self.max_slots) if not self.live[i]]

    def admit(self, req: Request):
        """Prefill a request into a free slot: a batch-1 prefill of the
        prompt (pow2-bucketed when sound, else at its exact length; on
        zero frames where the config has an encoder) into a fresh cache,
        spliced into the slot."""
        free = self._free_slots()
        if not free:
            raise RuntimeError("no free slots")
        slot = free[0]
        S = len(req.prompt)
        if not 0 < S < self.max_len:
            raise ValueError(f"prompt of {S} tokens does not fit "
                             f"max_len={self.max_len}")
        L = (min(_next_pow2(S), self.max_len - 1) if self._bucket_prompts
             else S)
        tokens = np.zeros(L, np.int64)
        tokens[:S] = req.prompt
        tmp_cache = model_lib.init_cache(self.cfg, 1, self.max_len,
                                         dtype=self.dtype,
                                         device=self.device)
        frames = None
        if self.cfg.encoder is not None:
            frames = torch.zeros(
                (1, self.cfg.encoder.n_frames, self.cfg.d_model),
                dtype=self.dtype, device=self.device)
        tmp_cache, logits = model_lib.prefill(
            self.params, self.cfg,
            torch.as_tensor(tokens[None], device=self.device), tmp_cache,
            compute_dtype=self.dtype,
            last_index=S - 1 if self._bucket_prompts else None,
            frames=frames)
        for path, dst in _leaves(self.cache):
            _slot_of(dst, path, slot).copy_(
                _slot_of(_at(tmp_cache, path), path, 0))
        self.lengths[slot] = S
        self.live[slot] = True
        self.active[slot] = True
        req.slot = slot
        self.slot_req[slot] = req
        first = int(torch.argmax(logits[0]))
        req.generated.append(first)
        self.last_token[slot] = first
        self._trace_session("admit", req.rid, flow="s", slot=slot,
                            prompt_len=S)
        return slot

    def _slot_blob(self, slot: int):
        """(float32 blob, leaf layout) of a slot's cache block (its KV and
        recurrent state), leaves in `jax.tree.leaves` order."""
        flat = [(path, _slot_of(leaf, path, slot))
                for path, leaf in _leaves(self.cache)]
        blob = torch.cat([t.float().reshape(-1) for _, t in flat])
        layout = [(p, tuple(t.shape), t.dtype) for p, t in flat]
        return blob.cpu().numpy(), layout

    def _slot_of_rid(self, rid: str) -> int:
        """Slot currently decoding `rid`; KeyError when the session is not
        live here — unknown, already paused, or finished."""
        for s, r in self.slot_req.items():
            if r.rid == rid:
                return s
        state = ("paused" if rid in self._paused else "not live")
        raise KeyError(f"session {rid!r} is {state} on this engine; "
                       f"only live sessions can be paused or "
                       f"checkpointed")

    # -------------------------------------------------------------- pausing
    def pause(self, rid: str):
        """Offload a session's KV block through the tiered store."""
        slot = self._slot_of_rid(rid)
        req = self.slot_req.pop(slot)
        blob, layout = self._slot_blob(slot)
        self.store.put(("kv", rid), blob)
        state = (req, layout, int(self.lengths[slot]))
        self._paused[rid] = state
        # a pause is also the freshest durable point for the session
        self._checkpoints[rid] = state
        self.live[slot] = False
        self.active[slot] = False
        self.lengths[slot] = 0
        tier = self.store.tier_of(("kv", rid))
        self._trace_session("pause", rid, flow="t", slot=slot,
                            tier=getattr(tier, "name", str(tier)))
        return tier

    def park(self, rid: str) -> int:
        """Idle a live session in place: the slot and its KV stay
        resident but the slot stops decoding until `unpark`."""
        slot = self._slot_of_rid(rid)
        self.active[slot] = False
        return slot

    def unpark(self, rid: str) -> int:
        """Reactivate a parked session; decode picks up exactly where
        it left off (the parked slot's pending KV position is rewritten
        by the first real decode)."""
        slot = self._slot_of_rid(rid)
        self.active[slot] = True
        return slot

    # -------------------------------------------------------- checkpointing
    def checkpoint_session(self, rid: str):
        """Durable snapshot of a *live* session without evicting it: the
        slot's KV block is re-put to the store and restart metadata is
        recorded, but decode keeps running in place."""
        slot = self._slot_of_rid(rid)
        req = self.slot_req[slot]
        blob, layout = self._slot_blob(slot)
        self.store.put(("kv", rid), blob)
        # snapshot the request: later decode steps on this engine must
        # not mutate the checkpointed token list
        self._checkpoints[rid] = (
            dataclasses.replace(req, slot=None,
                                generated=list(req.generated)),
            layout, int(self.lengths[slot]))
        return self.store.tier_of(("kv", rid))

    def checkpoint_live(self):
        """Checkpoint every live, unfinished session (slot order)."""
        rids = [r.rid for s, r in sorted(self.slot_req.items())
                if self.live[s] and not r.done]
        for rid in rids:
            self.checkpoint_session(rid)
        return rids

    def checkpoints(self) -> Dict[str, tuple]:
        """rid -> restart state, the tuple format `import_session`
        takes."""
        return dict(self._checkpoints)

    def restore_checkpoint(self, rid: str, state=None):
        """Re-admit a session from its last checkpoint (here, or with
        `state` from another engine's `checkpoints()`). Returns the
        landing slot; the session re-decodes from the checkpointed
        position."""
        if state is None:
            state = self._checkpoints[rid]
        if rid not in self._paused:
            self.import_session(rid, state)
        return self.resume(rid)

    def export_session(self, rid: str):
        """Hand a paused session off to another engine on the same store
        or fabric: returns the session metadata (request + KV layout). The
        KV block itself stays in the tiered store/fabric and streams to
        the resuming host on its `prefetch`/`resume`."""
        # a prefetch issued here is dropped: its transfer completes on
        # its own in the background
        self._pending.pop(rid, None)
        state = self._paused.pop(rid)
        # torn-session guard: metadata must never outlive the KV blob
        if self.store.tier_of(("kv", rid)) is None:
            self._paused[rid] = state
            raise KeyError(
                f"session {rid!r}: KV blob has no surviving copy; "
                f"cannot export a torn session")
        self._checkpoints.pop(rid, None)
        return state

    def import_session(self, rid: str, state):
        """Adopt a session exported by another engine on the same store
        or fabric; `prefetch`/`resume` then work as if paused here."""
        if rid in self._paused:
            raise KeyError(f"session {rid!r} already paused here")
        self._paused[rid] = state

    def locality_host(self, rid: str) -> int:
        """Host a resuming session should be routed to: one already
        holding its KV replica (the remote NIC + remote-flash restore
        becomes a plain local read), else this engine's host. Only
        meaningful in fabric mode — a single-host store is its own
        locality."""
        fab = getattr(self.store, "fabric", None)
        if fab is None:
            return self.host
        return fab.preferred_host(("kv", rid), default=self.host)

    def prefetch_lead(self, rid: str) -> int:
        """p99-sized prefetch lead for `rid` in decode steps (one step
        when `step_time` is 0)."""
        if self.step_time <= 0:
            return 1
        return self.store.prefetch_lead_steps(("kv", rid), self.step_time)

    def prefetch(self, rid: str):
        """Issue a paused session's KV restore asynchronously: the fetch
        streams from its tier while decode steps keep advancing the clock.
        Idempotent; returns the pending handle."""
        if rid not in self._paused:
            raise KeyError(rid)
        if rid not in self._pending:
            self._pending[rid] = self.store.get_async(("kv", rid))
            self._trace_session("prefetch", rid, flow="t")
        return self._pending[rid]

    def prefetch_many(self, rids):
        """Batched async restore: issue all fetches back-to-back so the
        flash queue pipelines them (miss-under-miss)."""
        return [self.prefetch(r) for r in rids]

    def resume(self, rid: str):
        """Re-admit a paused session. Blocks only on the unfinished part
        of its (pre)fetch; the stall lands in `kv_stall_time`."""
        if rid not in self._paused:
            raise KeyError(f"session {rid!r} is not paused on this "
                           f"engine")
        # secure the slot *before* consuming any session state: the
        # no-free-slots failure must leave the session fully resumable
        free = self._free_slots()
        if not free:
            raise RuntimeError("no free slots")
        slot = free[0]
        req, layout, length = self._paused.pop(rid)
        pf = self._pending.pop(rid, None)
        if pf is None:
            pf = self.store.get_async(("kv", rid))
        t0 = self.clock.now()
        blob = pf.wait()
        stall = self.clock.now() - t0
        self.kv_stall_time += stall
        self._trace_session("resume", rid, flow="f", slot=slot,
                            stall=stall)
        flat = torch.from_numpy(blob).to(self.device)
        off = 0
        for path, shape, _dtype in layout:
            n = int(np.prod(shape))
            dst = _slot_of(_at(self.cache, path), path, slot)
            dst.copy_(flat[off:off + n].view(shape))
            off += n
        self.lengths[slot] = length
        self.live[slot] = True
        self.active[slot] = True
        if req.generated:
            self.last_token[slot] = req.generated[-1]
        req.slot = slot
        self.slot_req[slot] = req
        return slot

    # ---------------------------------------------------------------- step
    def step(self):
        """One decode step for all live, non-parked slots. Parked and dead
        slots ride through the fixed-shape decode but their state is
        masked out: the garbage KV written at their pending position is
        overwritten by the first real decode after unpark/admit, and a
        recurrent sublayer writes new state only for the decoding slots
        (`active`), so a parked slot's state holds."""
        act = self.live & self.active
        if not act.any():
            return
        dev = self.device
        self.cache, logits = model_lib.decode_step(
            self.params, self.cfg,
            torch.as_tensor(self.last_token[:, None], device=dev),
            self.cache, torch.as_tensor(self.lengths, device=dev),
            compute_dtype=self.dtype, active=torch.as_tensor(act))
        self.steps += 1
        if self.step_time:
            # modeled decode compute overlaps in-flight KV transfers
            self.store.runtime.advance(self.step_time)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.last_token = np.where(act, nxt, self.last_token)
        self.lengths[act] += 1
        for slot, req in list(self.slot_req.items()):
            if not act[slot]:
                continue
            req.generated.append(int(nxt[slot]))
            if (len(req.generated) >= req.max_new
                    or self.lengths[slot] >= self.max_len - 1):
                req.done = True
                self.live[slot] = False
                self.active[slot] = False
                del self.slot_req[slot]
                self._checkpoints.pop(req.rid, None)
        if (self.checkpoint_interval and self.live.any()
                and self.steps % self.checkpoint_interval == 0):
            self.checkpoint_live()

    def run(self, requests: List[Request], max_steps: int = 1000):
        """Simple gang scheduler loop: admit as slots free up, decode
        until all requests complete."""
        pending = list(requests)
        done: List[Request] = []
        done_rids = set()
        steps = 0
        while (pending or self.live.any()) and steps < max_steps:
            while pending and self._free_slots():
                self.admit(pending.pop(0))
            self.step()
            steps += 1
            for r in requests:
                if r.done and r.rid not in done_rids:
                    done_rids.add(r.rid)
                    done.append(r)
        return done


def route_session(engines: Dict[int, "DecodeEngine"], rid: str,
                  state=None) -> "DecodeEngine":
    """Locality-aware session routing across a fleet of engines (one per
    fabric host): pick the engine whose host already holds the session's
    KV replica, so the restore is a local flash read instead of the NIC
    + remote-flash composition. Falls back to the first engine when no
    replica exists (fresh session) or the holder runs no engine. When
    `state` (from `export_session`) is given, the session is imported
    into the chosen engine."""
    if not engines:
        raise ValueError("no engines to route over")
    first = next(iter(engines.values()))
    host = first.locality_host(rid)
    target = engines.get(host, first)
    if state is not None:
        target.import_session(rid, state)
    return target
