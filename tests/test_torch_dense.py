"""deepseek-7b, mistral-nemo-12b, granite-20b, qwen3-moe-235b-a22b,
llama4-maverick-400b-a17b, zamba2-7b, xlstm-350m, qwen2-vl-2b and
whisper-medium (reduced, float32)
through the port's
entry points against the JAX reference's: the `serve_tiered_kv` twin with
`--arch` against the reference script with the same flag, and the
declared tenant pack through Platform.compile -> Platform.scheduler ->
run(Platform.jobs()) on both sides. gemma-2b's cases of the same checks
are in tests/test_torch_platform.py and tests/test_torch_scheduler.py;
the model and engine parity of every ported config in
tests/test_torch_model.py and tests/test_torch_serving.py.

What must match: the twin's lines from `[tiering]` on (tiers, stall and
both report tables: modeled, so exact); the scheduler's outcome, trace,
ledger and tau_be as `_both` holds them (integers and tokens equal,
floats to 1e-12 relative). The recurrent configs' (zamba2-7b's,
xlstm-350m's) sessions that the scheduler parked are held to the port's
own lock-step run instead of the reference's tokens (see
`_declared_workload_matches_reference`)."""
import pathlib
import runpy
import sys

import pytest

from test_torch_platform import _capture, _modeled
from test_torch_scheduler import _declared_workload_matches_reference, \
    _sides

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("deepseek-7b", "mistral-nemo-12b", "granite-20b",
         "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "zamba2-7b",
         "xlstm-350m", "qwen2-vl-2b", "whisper-medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_example_twin_matches_reference_script(monkeypatch, arch):
    from repro_torch.examples import serve_tiered_kv as twin
    got = _capture(lambda: twin.main(["--arch", arch, "--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["serve_tiered_kv.py", "--arch", arch])
    want = _capture(lambda: runpy.run_path(
        str(ROOT / "examples" / "serve_tiered_kv.py"),
        run_name="__main__"))
    assert _modeled(got) == _modeled(want)
    assert got[0].startswith("[serve] 6/6 requests, 72 tokens")
    assert got[0].split(", ")[-1] == want[0].split(", ")[-1]
    assert any(ln.startswith("[tier stats]") for ln in _modeled(got))


@pytest.fixture(scope="module", params=ARCHS)
def sides(request):
    return _sides(request.param)


@pytest.mark.parametrize("isolation", ["per-tenant", "shared"])
def test_platform_scheduler_serves_declared_workload_like_reference(
        sides, isolation):
    _declared_workload_matches_reference(sides, isolation)
