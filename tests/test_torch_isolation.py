"""The PyTorch port stands alone: it never imports jax or the reference
package, and its entry points refuse to fall back to the CPU quietly."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_port_module_imports_with_jax_poisoned():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_device_without_cuda(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import DecodeEngine

    cfg = get_config("gemma-2b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_cache(cfg, 1, 8)
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.params_from_jax(
            {k: v for k, v in params.items()}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(cfg, params, max_slots=1, max_len=8)
    # the explicit choice runs
    eng = DecodeEngine(cfg, params, max_slots=1, max_len=8, device="cpu")
    assert eng.cache["groups"]["L0S0"]["k"].device.type == "cpu"


def test_platform_entry_points_need_a_device_without_cuda(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart, serve_tiered_kv
    from repro_torch.models import model as M
    from repro_torch.platform import HierarchySpec, Platform, PolicyDecl

    cfg = get_config("gemma-2b", reduced=True)
    params = M.init_params(cfg, 0, device="cpu")
    for policy in (PolicyDecl.pinned_dram(), PolicyDecl.economic()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Platform.compile(HierarchySpec(policy=policy))
    # a platform assembled without a device hands its engines none
    cpu = Platform.compile(HierarchySpec(policy=PolicyDecl.pinned_dram()),
                           device="cpu")
    bare = Platform(cpu.spec, cpu.clock, cpu.fabric)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bare.engine(cfg, params, max_slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bare.scheduler(cfg, params, max_slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_tiered_kv.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])
    # the explicit choice runs, and the engine takes the platform's
    eng = cpu.engine(cfg, params, max_slots=1, max_len=8)
    assert eng.device.type == "cpu"
    sched = cpu.scheduler(cfg, params, max_slots=1, max_len=8)
    assert sched.engine.device.type == "cpu"


def test_engine_rejects_params_on_another_device():
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import DecodeEngine

    cfg = get_config("gemma-2b", reduced=True)
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="engine runs on meta"):
        DecodeEngine(cfg, params, max_slots=1, max_len=8, device="meta")


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch import kernels as K

    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="all on one CUDA device"):
        K.rmsnorm(x, torch.ones(64, device="meta"))
    with pytest.raises(ValueError, match="all on one CUDA device"):
        K.decode_attention(torch.empty(1, 2, 32, device="meta"),
                           torch.empty(1, 1, 4, 32),
                           torch.empty(1, 1, 4, 32),
                           torch.ones(1, dtype=torch.int32))
    np.testing.assert_equal(K.launch_counts(),
                            {"rmsnorm": 0, "decode_attention": 0,
                             "flash_attention": 0, "cuckoo_probe": 0,
                             "ann_topk": 0, "reuse_sketch": 0})
