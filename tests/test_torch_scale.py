"""The port's control-plane scale replay (`serving/scale.py`), the
vectorized service ladder (`SsdQueueModel.service_total_batch`) and the
`serving_scale` twin (`python -m repro_torch.benchmarks.serving_scale`)
against the JAX reference's.

What must match, and how closely:
  * `service_total_batch`: equal, value for value, to the reference's
    and to the port's scalar `service(...).total`;
  * `scale_replay`'s modeled record: equal, key for key and float for
    float, with the metrics plane on and off (the replay's host arrays
    are the reference's numpy; its sketch takes its plain version on
    `device="cpu"`, which chip_smoke.py phase 14 holds the card to);
  * the twin's JSON: byte for byte, but for `compare.splice_traces`,
    the reference engine's count of jit retraces. Torch traces no
    programs, so the twin has no such key (as
    `tests/test_torch_platform.py::test_cross_host_resume_matches_reference`
    leaves out the reference's retrace count). Its stderr equals the
    reference's but for the measured wall-clock lines."""
import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.obs import Observability as JObs
from repro.runtime.service import SsdQueueModel as JModel
from repro.serving.scale import scale_replay as j_scale_replay
from repro_torch.benchmarks import serving_scale as twin
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.obs import Observability as TObs
from repro_torch.runtime.service import SsdQueueModel
from repro_torch.serving.scale import _prior_or_inf, scale_replay

ROOT = pathlib.Path(__file__).resolve().parents[1]
# tests/test_control_plane.py's replay
SMALL = dict(n_keys=3000, n_sessions=300, n_steps=6, accesses_per_step=400,
             n_hosts=3, seed=7)


@pytest.mark.parametrize("nbytes", [4096, 128 << 10, 1 << 20],
                         ids=["4KiB", "128KiB", "1MiB"])
def test_service_total_batch_equals_reference_and_scalar(nbytes):
    depths = np.arange(1, 129)
    model = SsdQueueModel.shared()
    got = model.service_total_batch(nbytes, depths)
    assert got.dtype == np.float64 and got.shape == (128,)
    want = JModel.shared().service_total_batch(nbytes, depths)
    assert got.tobytes() == want.tobytes()
    scalar = np.array([model.service(nbytes, int(d)).total for d in depths])
    assert got.tobytes() == scalar.tobytes()
    # off-grid and clipped depths, as the reference test prices them
    odd = [1, 2, 3, 7, 16, 100, 128, 500]
    np.testing.assert_array_equal(
        model.service_total_batch(nbytes, odd),
        [model.service(nbytes, d).total for d in odd])


@pytest.mark.parametrize("metrics", [False, True], ids=["obs_off", "obs_on"])
def test_scale_replay_matches_reference(metrics):
    port_obs, ref_obs = (TObs(), JObs()) if metrics else (None, None)
    got, timings = scale_replay(**SMALL, obs=port_obs, device="cpu")
    want, _ = j_scale_replay(**SMALL, obs=ref_obs)
    assert json.dumps(got) == json.dumps(want)
    assert got == want
    assert got["ops_dram_hits"] + got["ops_flash_misses"] == got["accesses"]
    assert got["ops_sketch_updates"] == SMALL["n_steps"]
    assert set(timings) == {"digest", "routing", "tracking", "admission",
                            "stall_pricing", "metrics", "total",
                            "keys_per_sec"}
    if metrics:
        assert port_obs.metrics.snapshot() == ref_obs.metrics.snapshot()
        assert port_obs.ledger.totals == ref_obs.ledger.totals
        assert port_obs.ledger.totals["flash_service"] == pytest.approx(
            got["total_stall"], rel=1e-12)


def test_scale_replay_record_does_not_depend_on_metrics():
    off, _ = scale_replay(**SMALL, device="cpu")
    on, _ = scale_replay(**SMALL, obs=TObs(), device="cpu")
    assert off == on


def test_scale_replay_dedupes_misses_per_step():
    """One cold key touched 50x in a step queues ONE flash fetch; the
    49 repeats are served by it. Distinct cold keys still queue behind
    each other (tests/test_control_plane.py's regression)."""
    l_blk = 128 << 10
    model = SsdQueueModel.shared()
    rec, _ = scale_replay(n_keys=100, n_sessions=10, n_hosts=2,
                          l_blk=l_blk, trace=[np.full(50, 7, np.int64)],
                          device="cpu")
    assert rec["ops_flash_misses"] == 1.0
    assert rec["ops_dram_hits"] == 49.0
    assert rec["accesses"] == 50.0
    assert rec["total_stall"] == pytest.approx(
        model.service(l_blk, 1).total)
    rec2, _ = scale_replay(n_keys=100, n_sessions=10, n_hosts=2,
                           l_blk=l_blk, trace=[np.arange(4, dtype=np.int64)],
                           device="cpu")
    assert rec2["ops_flash_misses"] == 4.0
    assert rec2["total_stall"] == pytest.approx(
        sum(model.service(l_blk, d).total for d in (1, 2, 3, 4)))
    for trace, port in ((np.full(50, 7, np.int64), rec),
                        (np.arange(4, dtype=np.int64), rec2)):
        want, _ = j_scale_replay(n_keys=100, n_sessions=10, n_hosts=2,
                                 l_blk=l_blk, trace=[trace])
        assert port == want


def test_prior_or_inf_explicit_none_check():
    """Only a missing prior means "never reused": 0.0 stays maximally hot."""
    assert _prior_or_inf(None) == np.inf
    assert _prior_or_inf(0.0) == 0.0
    assert _prior_or_inf(2.5) == 2.5


def test_scale_replay_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale_replay(n_keys=100, n_sessions=10, n_steps=1,
                     accesses_per_step=10, n_hosts=2)


def _load_reference_cli():
    path = ROOT / "benchmarks" / "serving_scale.py"
    spec = importlib.util.spec_from_file_location("serving_scale_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn()
    return out.getvalue(), err.getvalue().splitlines()


def _modeled_lines(err):
    """stderr without the measured wall-clock section."""
    start = err.index("control plane (measured wall-clock, this machine — "
                      "reported separately from modeled stall):")
    return err[:start] + err[start + 8:]


def test_serving_scale_twin_matches_reference_smoke(tmp_path, monkeypatch):
    """`--smoke --device cpu` with the reference's weights (through
    `params_from_jax`) in the twin's `run_compare`."""
    jcfg, cfg = (j_get_config("gemma-2b", reduced=True),
                 get_config("gemma-2b", reduced=True))
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    inner = twin.run_compare
    monkeypatch.setattr(twin, "run_compare", lambda *a, **k: inner(
        *a, params=params, **k))
    port = _run(lambda: twin.main(["--smoke", "--device", "cpu", "--out",
                                   str(tmp_path / "port.json")]))
    monkeypatch.setattr(sys, "argv", ["serving_scale.py", "--smoke",
                                      "--out", str(tmp_path / "ref.json")])
    ref = _run(_load_reference_cli().main)

    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    splice = want["compare"].pop("splice_traces")
    assert set(splice) and "splice_traces" not in got["compare"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert json.loads(port[0]) == got
    assert _modeled_lines(port[1]) == _modeled_lines(ref[1])
    cell = got["compare"]["zipf"]
    assert cell["tokens_identical"] and cell["continuous_wins"]
    assert got["scale"]["ops_sketch_updates"] == 30.0


def test_serving_scale_twin_skip_compare_byte_identical(tmp_path,
                                                         monkeypatch):
    """The replay alone, at reduced sizes: the `--out` files equal byte
    for byte (no compare part, so nothing is left out)."""
    argv = ["--keys", "20000", "--sessions", "2000", "--steps", "8",
            "--accesses", "3000", "--hosts", "4", "--skip-compare"]
    port = _run(lambda: twin.main(argv + ["--device", "cpu", "--out",
                                          str(tmp_path / "port.json")]))
    monkeypatch.setattr(sys, "argv", ["serving_scale.py"] + argv + [
        "--out", str(tmp_path / "ref.json")])
    ref = _run(_load_reference_cli().main)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert port[0] == ref[0]
    assert _modeled_lines(port[1]) == _modeled_lines(ref[1])


def test_serving_scale_twin_device_flag():
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            twin.main(["--smoke", "--device", "tpu"])
