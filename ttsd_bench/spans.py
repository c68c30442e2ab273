"""The port's own spans (``moss_ttsd_torch/utils/profiling.py``), read
where the program keeps them: the one module of the benchmark that reads
the span store. The window's batches are the last ``len(layer["batches"])``
``pipeline.batch`` roots, the batches ``cells.BatchProbe`` times (the
profiled first batch left out when the window ran others). A program
without spans gives None, and the metrics that read them are left out of
the line.
"""

from __future__ import annotations

from typing import List, Optional

SETUP = ("setup.codec", "setup.lm", "setup.kernels")


def store():
    """The port's process-wide registry, if it keeps spans."""
    try:
        from moss_ttsd_torch.utils.profiling import metrics
    except ImportError:
        return None
    return metrics if hasattr(metrics, "span_roots") else None


def window(layer) -> Optional[List[dict]]:
    """The window's ``pipeline.batch`` roots, oldest first."""
    m, n = store(), len(layer.get("batches") or [])
    if m is None or not n:
        return None
    roots = m.span_roots("pipeline.batch")
    return roots[-n:] if len(roots) >= n else None


def seconds(roots: List[dict], name: str) -> float:
    return sum(r["spans"].get(name, {}).get("s", 0.0) for r in roots)


def per_step_ms(layer, names) -> Optional[float]:
    """The seconds of ``names`` over the window's decode steps (one
    ``engine.step`` a step), in ms."""
    roots = window(layer)
    if roots is None:
        return None
    steps = sum(r["spans"].get("engine.step", {}).get("calls", 0)
                for r in roots)
    return (1e3 * sum(seconds(roots, n) for n in names) / steps
            if steps else None)


def setup_seconds() -> Optional[float]:
    """The process's program set-up: codec, LM and kernel build spans."""
    m = store()
    if m is None:
        return None
    snap = m.snapshot()
    if not any(f"{n}_calls" in snap for n in SETUP):
        return None
    return sum(snap.get(f"{n}_s", 0.0) for n in SETUP)
