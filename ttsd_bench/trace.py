"""The traced run's device trace: a ``torch.profiler`` capture of a few
steady steps, read back from its Chrome trace.

``Capture`` starts and stops the profiler from inside the program's own
thread (the steps are marked with ``record_function`` labels by the probe)
and reduces the trace to: the traced window; the device's busy seconds
(the union of kernel, copy and set intervals) and idle share; kernel
launches (runtime launch calls) inside each labelled step; every kernel's
device time by name; the longest idle gaps, named by the host operation
running when each began.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Capture:
    """One profiler window. ``start()`` and ``stop()`` are called by the
    probe around the steps it traces; ``reduce()`` reads the trace."""

    def __init__(self):
        self.prof = None
        self.done = False
        self.warmed = False
        self.stop_s = 0.0
        self.summary: Optional[dict] = None

    @staticmethod
    def _activities():
        import torch
        from torch.profiler import ProfilerActivity
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        return [ProfilerActivity.CPU]

    def warm(self) -> None:
        """Start and stop an empty capture: the first start initialises
        the tracer (seconds), which belongs to set-up, not to the window."""
        import torch
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.zeros(1).add_(1)
        self.warmed = True

    def start(self) -> None:
        from torch.profiler import profile
        self.prof = profile(activities=self._activities())
        self.prof.start()

    def stop(self) -> None:
        import time
        self._activities()               # synchronizes the card
        t0 = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t0
        self.done = True

    def reduce(self, step_label: str) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = summarize(events, step_label)
        self.summary["stop_s"] = self.stop_s
        return self.summary


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], step_label: str) -> dict:
    """Chrome-trace events (times in microseconds) -> the reductions the
    per-layer metrics read. The window runs from the first labelled
    step's start to the last device operation's end."""
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("name") == step_label
                   and e.get("cat") == "user_annotation")
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    launches = sorted(e["ts"] for e in events if e.get("ph") == "X"
                      and e.get("name") in LAUNCH_CALLS)
    kernels: Dict[str, List[float]] = defaultdict(list)
    for e in dev:
        if e["cat"] == "kernel":
            kernels[e["name"]].append(e["dur"] * 1e-6)
    if not steps or not dev:
        return {"steps": len(steps), "kernels": dict(kernels)}
    w0 = steps[0][0]
    busy = _merge([(max(e["ts"], w0), e["ts"] + e["dur"]) for e in dev
                   if e["ts"] + e["dur"] > w0])
    w1 = max(steps[-1][1], busy[-1][1] if busy else w0)
    busy_us = sum(b - a for a, b in busy)
    in_steps = sum(bisect.bisect_right(launches, b)
                   - bisect.bisect_left(launches, a) for a, b in steps)
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                             "user_annotation")
                  and e.get("name") != step_label)
    starts = [h[0] for h in host]
    by_host: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_right(starts, a)
        best = None
        for j in range(i - 1, max(-1, i - 400), -1):
            s, t, name = host[j]
            if s <= a < t and (best is None or t - s < best[0]):
                best = (t - s, name)
        by_host[best[1] if best else "(no host op)"] += (b - a) * 1e-6
    ops = sorted(((n, sum(v)) for n, v in kernels.items()),
                 key=lambda x: -x[1])[:10]
    return {"steps": len(steps), "window_s": (w1 - w0) * 1e-6,
            "busy_s": busy_us * 1e-6, "launches": in_steps,
            "kernels": dict(kernels),
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in sorted(
                by_host.items(), key=lambda x: -x[1])[:10]]}


def kernel_seconds(summary: dict, match) -> Tuple[int, float]:
    """(calls, device seconds) of the kernels whose name ``match`` accepts."""
    n, s = 0, 0.0
    for name, durs in summary.get("kernels", {}).items():
        if match(name):
            n += len(durs)
            s += sum(durs)
    return n, s
