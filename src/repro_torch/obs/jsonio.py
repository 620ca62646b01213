"""Canonical bench-JSON emit.

Every `benchmarks/serving_*.py` is byte-diffed across a double run in
CI; the diff is only meaningful if serialization itself is pinned.
Before this module each bench hand-rolled `json.dumps(report,
sort_keys=True, indent=2)` and hoped no numpy scalar or
platform-dependent float repr leaked in. `bench_json` pins all of it:

  * keys sorted, two-space indent (the existing bench convention),
  * numpy scalars / arrays folded to plain Python before dumping,
  * every float routed through ``float(f"{x:.12g}")`` so the emitted
    digits don't depend on accumulated rounding noise below the 12th
    significant digit (re-running a sum in a different association
    order stays byte-identical),
  * non-finite floats mapped to strings ("inf"/"-inf"/"nan") — the
    JSON spec has no spelling for them and `json.dumps` would emit
    the non-portable `Infinity`.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np


def _canon_float(x: float) -> Union[float, str]:
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return float(f"{x:.12g}")


def canon(obj: Any) -> Any:
    """Fold `obj` into canonical plain-Python JSON-ready structure."""
    if isinstance(obj, dict):
        return {str(k): canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [canon(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [canon(v) for v in obj.tolist()]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return _canon_float(float(obj))
    return obj


def bench_json(report: Any) -> str:
    """Canonical JSON text for a bench report (no trailing newline)."""
    return json.dumps(canon(report), sort_keys=True, indent=2)


def write_bench_json(report: Any, out: Optional[Union[str, Path]] = None,
                     echo: bool = True) -> str:
    """The shared bench emit path: canonical dump, optional `--out`
    file (text + trailing newline), optional echo to stdout."""
    js = bench_json(report)
    if out is not None:
        Path(out).write_text(js + "\n")
    if echo:
        print(js)
    return js
