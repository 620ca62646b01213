"""The case-study and advisor example twins (`python -m
repro_torch.examples.{kvstore_demo,ann_search,provision_advisor} --device
cpu`) against the reference's `examples/` scripts, run in-process with
runpy: every printed line equal, except the host-clock and device-naming
parts named in MASKS, which are blanked on both sides (the port's side
must then name the plain version on the CPU)."""
import contextlib
import io
import pathlib
import re
import runpy
import sys

import pytest
import torch

from repro_torch.examples import ann_search, kvstore_demo, \
    provision_advisor

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = {"kvstore_demo": kvstore_demo, "ann_search": ann_search,
         "provision_advisor": provision_advisor}
# (pattern, replacement): the host clock, and what the reference names
# as its kernel ("interpret-mode kernel") where the port names the
# kernel or its plain version and the device
MASKS = {
    "kvstore_demo": [
        (re.compile(r"^(\[store\] \d+ items inserted at load [0-9.]+) in "
                    r"[0-9.]+s;"), r"\1 in <host clock>;"),
        (re.compile(r"^(\[store\] batched GET x\d+: \d+ found, \d+ values "
                    r"correct), \d+ms \((.*); (~1\.5 block reads/GET)\)$"),
         r"\1, <host clock> (<route>; \3)"),
    ],
    "ann_search": [
        (re.compile(r"^\[search\] wall: exact [0-9.]+s vs two-stage "
                    r"[0-9.]+s \(.*\)$"),
         "[search] wall: <host clock> (<route>)"),
    ],
    "provision_advisor": [],
}
ROUTES = {"kvstore_demo": "cuckoo_probe's plain version on CPU",
          "ann_search": "ann_topk's plain version on CPU"}


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def _masked(name, lines):
    out, n = [], 0
    for ln in lines:
        m = ln
        for pat, rep in MASKS[name]:
            m = pat.sub(rep, m)
        n += m != ln
        out.append(m)
    return out, n


def _both(name, argv, monkeypatch):
    got = _capture(lambda: TWINS[name].main(argv + ["--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    want = _capture(lambda: runpy.run_path(
        str(ROOT / "examples" / f"{name}.py"), run_name="__main__"))
    if name in ROUTES:
        assert sum(ROUTES[name] in ln for ln in got) == 1, got
    masked, n = _masked(name, got)
    masked_ref, n_ref = _masked(name, want)
    assert n == n_ref == len(MASKS[name])
    assert masked == masked_ref
    return got


def test_kvstore_demo_twin_matches_reference(monkeypatch):
    got = _both("kvstore_demo", [], monkeypatch)
    text = "\n".join(got)
    for want in ("45875 items inserted at load 0.700",
                 "E[chain]=0.0035 observed relocations=312",
                 "4096 found, 4096 values correct", "block_reads=54039",
                 "GPU+SN :   146.1 Mops/s", "CPU+SN :    90.9 Mops/s",
                 "GPU+NR :    15.6 Mops/s"):
        assert want in text, want


def test_ann_search_twin_matches_reference(monkeypatch):
    got = _both("ann_search", [], monkeypatch)
    text = "\n".join(got)
    for want in ("recall@10 = 0.9850", "12800 full-vector reads vs "
                 "4000000 reduced reads",
                 "GPU+SN  KQPS @ 64/256/512GB DRAM:    8.7 /   10.9 /   "
                 "13.0"):
        assert want in text, want


def test_ann_search_twin_flags_match_reference(monkeypatch):
    _both("ann_search", ["--n", "3000", "--queries", "40", "--promote",
                         "32"], monkeypatch)


@pytest.mark.parametrize("argv, expect", [
    ([], ("break-even tau  : 5.57s", "VERDICT: viable-optimal")),
    (["--trace", "scan_flood"],
     ("break-even tau  : 2.212s", "VERDICT: capacity-limited")),
    (["--advise-tiers", "--trace", "diurnal", "--rent-factor", "0.25"],
     ("tau_pool=8.524s", "both     : ", "<- recommended",
      "VERDICT: add both")),
    (["--platform", "cpu", "--l-blk", "4096", "--dram-gb", "64",
      "--sigma", "0.5"], ("platform: CPU+DDR",)),
], ids=["analytic", "trace_scan_flood", "advise_tiers_diurnal",
        "analytic_cpu_4k"])
def test_provision_advisor_twin_matches_reference(argv, expect,
                                                  monkeypatch):
    got = _both("provision_advisor", argv, monkeypatch)
    text = "\n".join(got)
    for want in expect:
        assert want in text, want
    if "--advise-tiers" in argv:
        rec = [ln for ln in got if "<- recommended" in ln]
        assert len(rec) == 1 and rec[0].lstrip().startswith("both")


@pytest.mark.parametrize("name, site, argv", [
    ("kvstore_demo", "repro_torch.kvstore.cuckoo.cuckoo_probe", []),
    ("ann_search", "repro_torch.ann.progressive.ann_topk",
     ["--n", "3000", "--queries", "40"]),
])
def test_route_line_names_what_the_wrapper_counted(name, site, argv,
                                                   monkeypatch):
    # the route comes from the wrapper's launch count around the call, not
    # from the device: a wrapper that counts a launch reads as the kernel
    import importlib
    mod_name, attr = site.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    wrapper = getattr(mod, attr)
    monkeypatch.setattr(wrapper, "launches", wrapper.launches)

    def counted(*a, **kw):
        wrapper.launches += 1
        return wrapper(*a, **kw)
    monkeypatch.setattr(mod, attr, counted)
    got = _capture(lambda: TWINS[name].main(argv + ["--device", "cpu"]))
    kernel = f"{attr} kernel on CPU"
    assert sum(kernel in ln for ln in got) == 1, got
    assert not any(ROUTES[name] in ln for ln in got), got


def test_provision_advisor_rejects_unknown_trace():
    with pytest.raises(SystemExit):
        provision_advisor.main(["--trace", "nope", "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_rejects_a_bad_device(name):
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            TWINS[name].main(["--device", "tpu"])


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_needs_a_device_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TWINS[name].main([])
