"""What the figures share: result rows printed as a compact table and
saved as JSON under the port's bench directory (the port's copy of the
``emit`` helper of the reference's ``benchmarks/common.py``)."""
from __future__ import annotations

import json
import os
from typing import Dict, List

from repro_torch.artifacts import bench_dir


def emit(name: str, rows: List[Dict], keys=None) -> str:
    """Print a compact table and save JSON under <artifacts>/bench/."""
    os.makedirs(bench_dir(), exist_ok=True)
    path = os.path.join(bench_dir(), name + ".json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    if rows:
        keys = keys or list(rows[0].keys())
        print(f"\n== {name} ==")
        print(",".join(keys))
        for r in rows:
            print(",".join(_fmt(r.get(k)) for k in keys))
    return path


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)
