"""What the per-layer metric readers (``metrics/<name>.py``) share, and how
the harness finds them: a reader is ``read(layer, cfg)`` over what the
traced run recorded (``cells.BatchProbe`` / ``cells.PoolProbe``) and
returns a number, or None when its run has nothing to read (then the
metric is left out of the line; a share of a roofline is never
reported as 0 for a kernel that did not run).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, List, Optional

from .counts import roofline_percent
from .trace import kernel_seconds

METRICS = Path(__file__).resolve().parent / "metrics"


def load(name: str) -> Callable:
    """The ``read`` of ``metrics/<name>.py``."""
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "ttsd_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def mean_ms(values) -> Optional[float]:
    values = list(values or [])
    return 1e3 * sum(values) / len(values) if values else None


def _trace(layer) -> dict:
    return layer.get("trace") or {}


def launches_per_step(layer) -> Optional[float]:
    t = _trace(layer)
    return t["launches"] / t["steps"] if t.get("steps") and "launches" in t \
        else None


def idle_percent(layer) -> Optional[float]:
    t = _trace(layer)
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def is_decode_int8(name: str) -> bool:
    """The split-K decode kernel instantiated over an int8 cache."""
    return "split_kernel" in name and ("signed char" in name
                                       or "int8" in name)


def roofline(layer, match, work: List[dict]) -> Optional[float]:
    """The kernels ``match`` accepts: the mean work of one call over their
    mean device time a call, as a share of the roofline."""
    calls, seconds = kernel_seconds(_trace(layer), match)
    if not calls or not work or seconds <= 0:
        return None
    flops = sum(w["flops"] for w in work) / len(work)
    nbytes = sum(w["bytes"] for w in work) / len(work)
    return roofline_percent(flops, nbytes, seconds / calls)
