"""Roofline hook: measured decode step times for the serving runtime.

`DecodeEngine.step_time` models the decode compute that overlaps KV
transfers. Without measurements it is a declared constant; a roofline
grid writes the per-step decode wall-time bound per architecture to
`results/dryrun/*__single.json` (the reference's
`benchmarks/roofline_report.py` writes this format; the H100 roofline
that will write it for the port is ROADMAP Queue 1 item 10).
`HierarchySpec.step_time="measured"` closes that loop: the compiled platform pulls `step_time_bound` from
the decode-shape roofline record and falls back to the spec's modeled
constant when no results exist (the wall-clock edge of the
clock-injection contract — nothing below the runtime reads hardware
time directly).
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Optional

ENV_RESULTS = "REPRO_ROOFLINE_RESULTS"

# src/repro_torch/platform/roofline_hook.py -> repo root is parents[3]
_DEFAULT_RESULTS = (pathlib.Path(__file__).resolve().parents[3]
                    / "results" / "dryrun")


def _results_dir(results_dir: Optional[str]) -> pathlib.Path:
    if results_dir is not None:
        return pathlib.Path(results_dir)
    env = os.environ.get(ENV_RESULTS)
    if env:
        return pathlib.Path(env)
    return _DEFAULT_RESULTS


def _step_time_of(path: pathlib.Path) -> Optional[float]:
    try:
        d = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    r = d.get("roofline")
    if not isinstance(r, dict):
        return None
    t = r.get("step_time_bound")
    if isinstance(t, (int, float)) and t > 0:
        return float(t)
    return None


def measured_step_time(arch: Optional[str] = None,
                       shape: str = "decode_32k",
                       results_dir: Optional[str] = None
                       ) -> Optional[float]:
    """Measured per-step decode wall time (seconds) from the roofline
    grid, or None when no usable record exists.

    `arch=None` scans every architecture's decode record and takes the
    slowest bound (the conservative fleet-wide overlap budget — a lead
    sized for the slowest step never under-covers a faster one).
    Deterministic: records are read in sorted filename order."""
    root = _results_dir(results_dir)
    if not root.is_dir():
        return None
    pattern = f"{arch}__{shape}__single.json" if arch is not None \
        else f"*__{shape}__single.json"
    times = [t for p in sorted(root.glob(pattern))
             if (t := _step_time_of(p)) is not None]
    if not times:
        return None
    return max(times)
