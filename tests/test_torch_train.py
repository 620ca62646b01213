"""The port's training path on the CPU against the JAX reference: the data
pipeline (batches byte for byte), the watchdog (events and rollbacks on
one scripted run), AdamW (`schedule_lr`, `global_norm`, `compress_int8`,
`apply_updates` on random trees), `loss_and_aux` and one `train_step` of
the dense reduced configs and Gemma 2's (tests/test_torch_backward.py
holds the recurrent, MoE and audio ones, and the backward kernels' plain
versions), all at float32.

A config's reference step is built once (`stepped_pair`, cached): a
jitted `repro.train.step.train_step` under `single_device_rules()` from
the reference's init, and the port's `train_step` from `state_from_jax`
of the same state. Tolerances: the loss terms within 1e-5; each gradient
leaf, mu and nu within 1e-4 of the leaf's largest magnitude; the updated
parameters within 1e-6 where the reference's |g| exceeds 1e-3 of its
leaf's largest. Adam's first step is sign(g) (scaled by the learning
rate, here the peak: one warmup step), so a float32 ulp in a gradient
near zero may flip its update; those entries are not held."""
import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.parallel.sharding import single_device_rules
from repro.train import step as JS
from repro.train import watchdog as JW
from repro_torch.data import pipeline as TP
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.train import watchdog as TW

from test_torch_model import GEMMA2, _configs

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4        # of each leaf's largest magnitude
PARAM_ATOL = 1e-6
SIGN_FLOOR = 1e-3       # |g| below this share of the leaf's max: not held
B, S = 2, 12
# one warmup step, so the first update is the peak rate's
OPT = dict(warmup_steps=1)
TRAIN_ARCHS = ["gemma-2b", "deepseek-7b", "mistral-nemo-12b", "granite-20b",
               "qwen2-vl-2b", GEMMA2]
BACKWARD_ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                  "zamba2-7b", "xlstm-350m", "whisper-medium"]


# ---------------------------------------------------------------------------
# shared with tests/test_torch_backward.py
# ---------------------------------------------------------------------------

def batch_of(cfg, seed=0, **extra):
    """A numpy batch: int32 tokens [B,S] (and frames for an encoder)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    batch.update(extra)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jtcfg(**kw):
    return JS.TrainConfig(optimizer=JA.AdamWConfig(**OPT),
                          compute_dtype=jnp.float32, **kw)


def _ttcfg(**kw):
    return TS.TrainConfig(optimizer=adamw.AdamWConfig(**OPT),
                          compute_dtype=torch.float32, **kw)


@functools.lru_cache(maxsize=None)
def _reference_state(arch):
    jcfg, cfg = _configs(arch)
    state, _ = JS.init_state(jax.random.PRNGKey(0), jcfg, _jtcfg())
    return jcfg, cfg, state, jax.tree.map(np.asarray, state)


def port_state(arch):
    """(reference config, port config, the reference's initial state as
    numpy, a fresh port state made from it on the CPU)."""
    jcfg, cfg, _, np_state = _reference_state(arch)
    return jcfg, cfg, np_state, TS.state_from_jax(np_state, cfg,
                                                  device="cpu")


def _numpy(tree):
    return {"/".join(p): t.detach().numpy() for p, t in adamw.leaves(tree)}


def _jflat(tree):
    return {"/".join(p): np.asarray(t)
            for p, t in adamw.leaves(jax.tree.map(np.asarray, tree))}


@functools.lru_cache(maxsize=None)
def stepped_pair(arch, microbatch=0):
    """One train step of `arch` on both packages from the same state and
    batch: {"ref": (state, metrics), "port": (state, metrics, grads)} as
    flat numpy dicts keyed by leaf path."""
    jcfg, cfg, jstate, np_state = _reference_state(arch)
    batch = batch_of(cfg)
    step = jax.jit(functools.partial(
        JS.train_step, cfg=jcfg, rules=single_device_rules(),
        tcfg=_jtcfg(microbatch=microbatch)))
    jnew, jm = step(jstate, jax.tree.map(jnp.asarray, batch))
    state = TS.state_from_jax(np_state, cfg, device="cpu")
    tcfg = _ttcfg(microbatch=microbatch)
    grads = None
    if not microbatch:
        _, _, grads = TS.grads_and_metrics(state["params"], cfg,
                                           torch_batch(batch), tcfg)
        grads = _numpy(grads)
    new, m = TS.train_step(state, batch, cfg=cfg, tcfg=tcfg)
    return {"arch": arch,
            "ref": ({"params": _jflat(jnew["params"]),
                     "mu": _jflat(jnew["opt"]["mu"]),
                     "nu": _jflat(jnew["opt"]["nu"]),
                     "step": int(jnew["opt"]["step"])},
                    {k: float(v) for k, v in jm.items()}),
            "port": ({"params": _numpy(new["params"]),
                      "mu": _numpy(new["opt"]["mu"]),
                      "nu": _numpy(new["opt"]["nu"]),
                      "step": int(new["opt"]["step"])},
                     {k: float(v) for k, v in m.items()}, grads)}


def check_loss(pair):
    """The loss terms of the step's batch within LOSS_ATOL."""
    ref, port = pair["ref"][1], pair["port"][1]
    for k in ("ce", "z_loss", "aux", "loss"):
        assert abs(port[k] - ref[k]) <= LOSS_ATOL, (pair["arch"], k,
                                                    port[k], ref[k])
    assert port["ppl_proxy"] == pytest.approx(ref["ppl_proxy"], rel=1e-5)


def _leaf_close(got, want, what):
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (what, path)
        tol = GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{what} {path}: {err:.3e} > {tol:.3e}"


def check_step(pair, grads=True):
    """Gradients (the reference's from its mu: mu = (1 - b1) g clip after
    one step), mu and nu leaf by leaf; the updated parameters where the
    reference's |g| clears SIGN_FLOOR of its leaf's max; lr, grad_norm
    and the step."""
    (rs, rm), (ps, pm, pg) = pair["ref"], pair["port"]
    assert set(ps["params"]) == set(rs["params"])
    assert ps["step"] == rs["step"] == 1
    b1 = adamw.AdamWConfig().b1
    clip = min(1.0, adamw.AdamWConfig().clip_norm / max(rm["grad_norm"],
                                                        1e-12))
    ref_g = {p: mu / ((1 - b1) * clip) for p, mu in rs["mu"].items()}
    if grads:
        _leaf_close(pg, ref_g, "grad")
    _leaf_close(ps["mu"], rs["mu"], "mu")
    _leaf_close(ps["nu"], rs["nu"], "nu")
    for path, w in rs["params"].items():
        g = np.abs(ref_g[path])
        sure = g > SIGN_FLOOR * g.max()
        assert sure.any() or not g.any(), path
        np.testing.assert_allclose(ps["params"][path][sure], w[sure],
                                   atol=PARAM_ATOL, rtol=0, err_msg=path)
    for k in ("lr", "grad_norm"):
        assert pm[k] == pytest.approx(rm[k], rel=1e-5), k


# ---------------------------------------------------------------------------
# the data pipeline and the watchdog
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,hosts", [
    (97, 16, 8, 0, 1), (97, 16, 8, 3, 2), (256000, 33, 4, 1, 4),
    (51865, 8, 6, 7, 3)])
def test_synthetic_batches_equal_the_reference_byte_for_byte(
        vocab, seq, batch, seed, hosts):
    for host in range(hosts):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
                  n_hosts=hosts, host_id=host)
        ref = JP.SyntheticLM(JP.DataConfig(**kw))
        port = TP.SyntheticLM(TP.DataConfig(**kw))
        assert port.host_batch == ref.host_batch
        for step in (0, 1, 2, 17, 1000):
            want, got = ref.batch_at(step), port.batch_at(step)
            assert sorted(got) == sorted(want) == ["tokens"]
            assert got["tokens"].dtype == want["tokens"].dtype == np.int32
            assert got["tokens"].tobytes() == want["tokens"].tobytes()


def test_prefetch_iterator_order_and_state_equal_the_reference():
    kw = dict(vocab=97, seq_len=8, global_batch=2, seed=5)
    ref = JP.PrefetchIterator(JP.SyntheticLM(JP.DataConfig(**kw)),
                              start_step=3)
    port = TP.PrefetchIterator(TP.SyntheticLM(TP.DataConfig(**kw)),
                               start_step=3)
    try:
        for _ in range(5):
            want, got = next(ref), next(port)
            assert got["tokens"].tobytes() == want["tokens"].tobytes()
            assert port.state() == ref.state()
        assert port.state() == {"step": 8}
    finally:
        ref.close()
        port.close()


def _watch(module, monkeypatch, script):
    """Run a Watchdog of `module` over `script` [(step seconds, loss)],
    the clock patched to advance by each step's seconds; returns its
    per-step outcome and its records."""
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    wd = module.Watchdog(module.WatchdogConfig(stall_patience=3,
                                               max_loss_spike=2.0))
    outcome = []
    for step, (dt, loss) in enumerate(script):
        wd.begin_step()
        now[0] += dt
        try:
            outcome.append(("events", wd.end_step(step, loss)))
        except module.RollbackSignal as sig:
            outcome.append(("rollback", sig.reason, sig.step, str(sig)))
    return outcome, (wd.straggler_events, wd.rollbacks, wd.step_ema,
                     wd.loss_ema, wd.best_loss, wd.since_best)


def test_watchdog_matches_the_reference_on_a_scripted_run(monkeypatch):
    """Stragglers, a loss spike, a NaN and a stall, with time.monotonic
    patched in both: the same events, RollbackSignals and records."""
    script = [(1.0, 5.0), (1.0, 4.9), (1.1, 4.8), (5.0, 4.7), (1.0, 4.7),
              (1.0, 4.75), (1.0, 4.72), (1.0, 30.0), (1.0, float("nan")),
              (0.9, 4.6), (4.0, 4.65), (1.0, 4.61), (1.0, 4.62),
              (1.0, 4.63)]
    want = _watch(JW, monkeypatch, script)
    got = _watch(TW, monkeypatch, script)
    assert got == want
    kinds = [o[0] for o in got[0]]
    assert kinds.count("rollback") == 2
    assert any("straggler" in o[1] for o in got[0] if o[0] == "events")
    assert any("stall" in o[1] for o in got[0] if o[0] == "events")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}, "e": (7,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return make(shapes)


def _to_torch(tree):
    return adamw.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees(got, want, atol=1e-6):
    want = _jflat(want)
    got = {k: v for k, v in _numpy(got).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_equals_the_reference(schedule):
    jc = JA.AdamWConfig(schedule=schedule, warmup_steps=10,
                        total_steps=200)
    tc = adamw.AdamWConfig(schedule=schedule, warmup_steps=10,
                           total_steps=200)
    for step in (0, 1, 5, 10, 11, 57, 199, 200, 1000):
        want = float(JA.schedule_lr(jc, jnp.asarray(step, jnp.int32)))
        got = adamw.schedule_lr(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-3), step


def test_global_norm_and_compress_int8_equal_the_reference():
    rng = np.random.default_rng(11)
    tree = _tree(rng, 3.0)
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert float(adamw.global_norm(_to_torch(tree))) == pytest.approx(
        want, rel=1e-6)
    for leaf, scale in ((tree["a"], 1.0), (tree["b"]["d"], 1e-3),
                        (np.zeros((4,), np.float32), 1.0)):
        g = leaf * scale
        err = rng.standard_normal(leaf.shape).astype(np.float32) * 1e-3
        wd, we = JA.compress_int8(jnp.asarray(g), jnp.asarray(err))
        td, te = adamw.compress_int8(torch.from_numpy(g),
                                     torch.from_numpy(err))
        np.testing.assert_allclose(td.numpy(), np.asarray(wd), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(te.numpy(), np.asarray(we), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("compress,clip,steps", [(0, 1.0, 3), (8, 1.0, 3),
                                                 (0, 0.0, 2), (8, 100.0, 2)])
def test_apply_updates_equals_the_reference(compress, clip, steps):
    """Several steps on random trees (params, then a new gradient a
    step): params, mu, nu, err and the metrics, at float32, atol 1e-6;
    the port updates its trees in place and returns them."""
    rng = np.random.default_rng(compress + steps)
    kw = dict(compress_bits=compress, clip_norm=clip, warmup_steps=2,
              total_steps=10)
    jc, tc = JA.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = JA.init_state(jp, jc)
    tp = _to_torch(params)
    ts = adamw.init_state(tp, tc)
    assert sorted(ts) == sorted(js)
    for _ in range(steps):
        grads = _tree(rng, 2.0)
        jp, js, jm = JA.apply_updates(jp, jax.tree.map(jnp.asarray, grads),
                                      js, jc)
        tp2, ts, tm = adamw.apply_updates(tp, _to_torch(grads), ts, tc)
        assert tp2 is tp
        _assert_trees(tp, jp)
        for name in ("mu", "nu") + (("err",) if compress else ()):
            _assert_trees(ts[name], js[name])
        assert int(ts["step"]) == int(js["step"])
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


# ---------------------------------------------------------------------------
# the loss and one train step
# ---------------------------------------------------------------------------

def _reference_loss(arch, batch):
    jcfg, _, jstate, _ = _reference_state(arch)
    fn = jax.jit(functools.partial(
        JM.loss_and_aux, cfg=jcfg, rules=single_device_rules(),
        compute_dtype=jnp.float32, remat=False))
    loss, m = fn(jstate["params"], batch=jax.tree.map(jnp.asarray, batch))
    return dict({k: float(v) for k, v in m.items()}, loss=float(loss))


@pytest.mark.parametrize("arch,case", [("gemma-2b", "loss_mask"),
                                       (GEMMA2, "loss_mask"),
                                       ("qwen2-vl-2b", "vision_prefix")])
def test_loss_terms_with_a_mask_and_a_vision_prefix(arch, case):
    """loss_and_aux at float32 with a loss_mask (ce and z-loss over the
    masked positions alone, and an all-zero mask's denominator of 1) and
    behind qwen2-vl's vision prefix of 16 patch embeddings (the loss on
    the text positions alone)."""
    _, cfg, _, state = port_state(arch)
    rng = np.random.default_rng(4)
    if case == "loss_mask":
        masks = [(rng.random((B, S)) < 0.6).astype(np.int32),
                 np.zeros((B, S), np.int32)]
        batches = [batch_of(cfg, loss_mask=m) for m in masks]
    else:
        vis = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
        batches = [batch_of(cfg, vision_embeds=vis)]
    for batch in batches:
        want = _reference_loss(arch, batch)
        with torch.no_grad():
            loss, m = TM.loss_and_aux(state["params"], cfg,
                                      torch_batch(batch),
                                      compute_dtype=torch.float32)
        got = dict({k: float(v) for k, v in m.items()}, loss=float(loss))
        for k in ("ce", "z_loss", "aux", "loss"):
            assert abs(got[k] - want[k]) <= LOSS_ATOL, (k, got[k], want[k])
        if case == "loss_mask" and not batch["loss_mask"].any():
            assert got["ce"] == 0.0 and got["loss"] == pytest.approx(
                got["aux"])


@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def stepped(request):
    return stepped_pair(request.param)


def test_loss_and_aux_matches_reference(stepped):
    check_loss(stepped)


def test_train_step_matches_reference(stepped):
    check_step(stepped)


def test_microbatch_matches_reference():
    """microbatch=1 at B = 2: two gradients summed in float32 and halved,
    the last microbatch's metrics with the mean loss, on both sides."""
    pair = stepped_pair(GEMMA2, microbatch=1)
    check_loss(pair)
    check_step(pair, grads=False)


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_policies_change_no_value(policy):
    """remat off and on under each policy: the same updated parameters,
    mu and nu bit for bit (the backward recomputes the same ops), on
    reduced llama4-maverick (a dense and an MoE layer a group) and
    Gemma 2's config."""
    for arch in ("llama4-maverick-400b-a17b", GEMMA2):
        runs = []
        for remat, pol in ((False, "nothing"), (True, policy)):
            _, cfg, _, state = port_state(arch)
            new, m = TS.train_step(state, batch_of(cfg), cfg=cfg,
                                   tcfg=_ttcfg(remat=remat,
                                               remat_policy=pol))
            runs.append((_numpy(new["params"]), _numpy(new["opt"]["mu"]),
                         float(m["loss"])))
        (p0, mu0, l0), (p1, mu1, l1) = runs
        assert l0 == l1
        for k in p0:
            assert np.array_equal(p0[k], p1[k]), (arch, k)
            assert np.array_equal(mu0[k], mu1[k]), (arch, k)


def test_init_state_and_unknown_policy():
    """Native init: float32 leaves that require grad, zero moments and
    step 0 on the CPU; an unknown remat policy raises."""
    cfg = _configs("gemma-2b")[1]
    state = TS.init_state(cfg, _ttcfg(), generator=3, device="cpu")
    for _, leaf in adamw.leaves(state["params"]):
        assert leaf.dtype == torch.float32 and leaf.requires_grad
    for _, mu in adamw.leaves(state["opt"]["mu"]):
        assert mu.dtype == torch.float32 and not mu.any()
    assert int(state["opt"]["step"]) == 0
    with pytest.raises(ValueError, match="remat_policy"):
        TS.train_step(state, batch_of(cfg), cfg=cfg,
                      tcfg=_ttcfg(remat_policy="everything"))
    assert dataclasses.fields(TS.TrainConfig)[0].name == "optimizer"
