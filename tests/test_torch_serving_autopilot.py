"""The `serving_autopilot` twin (`python -m
repro_torch.benchmarks.serving_autopilot --device cpu`) against the
reference's `benchmarks/serving_autopilot.py`, run in-process with
runpy: the JSON on stdout, the `--out` file and the `--trace` export
byte for byte, and the tables on stderr line for line."""
import contextlib
import io
import json
import pathlib
import runpy
import sys

import pytest

from repro_torch.benchmarks import serving_autopilot as twin

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(fn):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn()
    return out.getvalue(), err.getvalue().splitlines()


@pytest.mark.parametrize("argv", [
    ["--smoke"],
    ["--smoke", "--trace"],
    ["--autoscale"],
    ["--failover"],
    ["--smoke", "--failover", "--autoscale-scenario", "zipf"],
], ids=["smoke", "smoke_trace", "autoscale", "failover", "failover_zipf"])
def test_serving_autopilot_twin_byte_identical(argv, tmp_path, monkeypatch):
    runs = {}
    for side in ("port", "ref"):
        d = tmp_path / side
        d.mkdir()
        # the trace goes to its default name in the cwd on both sides
        monkeypatch.chdir(d)
        args = argv + ["--out", "report.json"]
        if side == "port":
            runs[side] = _run(lambda: twin.main(args + ["--device", "cpu"]))
        else:
            monkeypatch.setattr(sys, "argv",
                                ["serving_autopilot.py"] + args)
            runs[side] = _run(lambda: runpy.run_path(
                str(ROOT / "benchmarks" / "serving_autopilot.py"),
                run_name="__main__"))
    (out, err), (ref_out, ref_err) = runs["port"], runs["ref"]
    assert out == ref_out
    assert err == ref_err
    port, ref = tmp_path / "port", tmp_path / "ref"
    assert (port / "report.json").read_bytes() == \
        (ref / "report.json").read_bytes()
    traced = "--trace" in argv
    assert (port / "autopilot_trace.json").exists() == traced
    if traced:
        assert (port / "autopilot_trace.json").read_bytes() == \
            (ref / "autopilot_trace.json").read_bytes()
    rec = json.loads(out)
    if "--autoscale" in argv:
        assert rec["autoscale_wins"] and rec["final_within_one_of_advice"]
    elif "--failover" in argv:
        assert rec["zero_committed_loss_replicated"]
        assert rec["all_sessions_resume_replicated"]
    else:
        assert rec["wins"] >= 3 and ("stall_ledger" in rec) == traced


def test_serving_autopilot_twin_device_flag():
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            twin.main(["--smoke", "--device", "tpu"])
