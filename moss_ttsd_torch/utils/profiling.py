"""Profiling, metrics and numerical sanitizing, PyTorch port of
``moss_ttsd_tpu/utils/profiling.py``.

  * ``trace(...)`` — a ``torch.profiler`` capture of the enclosed block
    (host and, on the card, device activity), written as a Chrome trace
    into a directory; ``annotate(name)`` labels a region of it;
  * ``Metrics`` — a small process-wide registry of counters, gauges and
    latency windows that the pipeline phases and the server report into
    (``/v1/metrics``);
  * ``sanitize`` / ``assert_finite`` — NaN/Inf handling on tensors. The
    port runs eagerly, so ``assert_finite`` raises at once.

``start_profiler_server`` has no PyTorch counterpart (``torch.profiler``
has no live endpoint to attach to) and raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterator, Optional

import torch


# ---------------------------------------------------------------------------
# torch.profiler integration
# ---------------------------------------------------------------------------

def start_profiler_server(port: int = 9999) -> None:
    """The JAX package's live profiler endpoint; PyTorch has none."""
    raise NotImplementedError(
        f"a live profiler server (port {port}) has no PyTorch counterpart: "
        "torch.profiler only captures a block; use --profile_dir (trace)")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a host (+ device, when a card is present) trace of the
    enclosed block into ``log_dir/trace_<pid>_<time>.json`` (Chrome trace
    format; open in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Decorator/context: label a region in the profiler timeline."""
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class Metrics:
    """Thread-safe counters + cumulative timers.

    One process-wide default instance (``metrics``); pipelines report phase
    walltimes and token counts here so serving code can export them.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._windows: Dict[str, Deque[float]] = {}

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def observe(self, name: str, value: float, window: int = 1024) -> None:
        """Record one sample into a bounded sliding window; snapshot()
        exports {name}_p50/_p95 over the window plus a cumulative
        {name}_observed count."""
        with self._lock:
            w = self._windows.get(name)
            if w is None:
                w = self._windows[name] = deque(maxlen=window)
            w.append(float(value))
            self._counters[name + "_observed"] = \
                self._counters.get(name + "_observed", 0.0) + 1

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._counters[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name + "_s", time.perf_counter() - t0)
            self.add(name + "_calls", 1)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            for name, w in self._windows.items():
                if w:
                    v = sorted(w)
                    out[name + "_p50"] = v[len(v) // 2]
                    out[name + "_p95"] = v[min(len(v) - 1,
                                               int(len(v) * 0.95))]
            return out

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._windows.clear()


metrics = Metrics()


# ---------------------------------------------------------------------------
# NaN/Inf sanitizer
# ---------------------------------------------------------------------------

def sanitize(x: torch.Tensor, clamp: Optional[float] = None) -> torch.Tensor:
    """Replace NaN with 0 and clamp the magnitude (a floating tensor to 0.9
    of its dtype's max unless ``clamp`` is given)."""
    x = torch.nan_to_num(x)
    if clamp is None and x.is_floating_point():
        clamp = float(torch.finfo(x.dtype).max) * 0.9
    if clamp is not None:
        x = torch.clamp(x, -clamp, clamp)
    return x


def assert_finite(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Raise FloatingPointError if x has NaN/Inf (a host sync); returns x
    so it composes inline: ``h = assert_finite(h, "hidden")``."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite values in {name}")
    return x
