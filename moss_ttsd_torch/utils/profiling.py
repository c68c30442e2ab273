"""Profiling, metrics, spans and numerical sanitizing, PyTorch port of
``moss_ttsd_tpu/utils/profiling.py``.

  * ``trace(...)`` — a ``torch.profiler`` capture of the enclosed block
    (host and, on the card, device activity), written as a Chrome trace
    into a directory;
  * ``Metrics`` — a small process-wide registry of counters, gauges and
    latency windows that the pipeline phases and the server report into
    (``/v1/metrics``), and of spans: ``metrics.span(name, **attrs)``
    (also the module's ``span``) times a block of host code on
    ``time.perf_counter_ns`` with an id, its parent's id and the id of
    its root (the outermost span of one ``process_batch`` call or one
    server request). Each name's totals are published as the counters
    ``<name>_s``, ``<name>_self_s`` (less the time of its children on the
    thread) and ``<name>_calls``; the last ``Metrics.SPAN_ROOTS`` roots
    keep their totals by name (``span_roots()``), and a ring keeps the
    last ``Metrics.SPAN_RING`` raw spans (``recent_spans()``). A span
    adds no device work: no sync, no CUDA event, no kernel. While a
    ``torch.profiler`` session runs (``trace``, or any other), each span
    also opens a ``record_function`` of its name, so it lands in the
    session's trace over the operations it issued; otherwise that costs
    one flag test. ``label(name)`` is that profiler label alone, with no
    span; ``profiler_on()`` says whether such a session runs;
  * ``sanitize`` / ``assert_finite`` — NaN/Inf handling on tensors. The
    port runs eagerly, so ``assert_finite`` raises at once.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler


# ---------------------------------------------------------------------------
# torch.profiler integration
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a host (+ device, when a card is present) trace of the
    enclosed block into ``log_dir/trace_<pid>_<time>.json`` (Chrome trace
    format; open in Perfetto or chrome://tracing). The spans opened inside
    the block appear in it by name."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

_span_ids = itertools.count(1)
_NO_LABEL = contextlib.nullcontext()


def label(name: str):
    """A profiler label alone, for blocks too many to time as spans (each
    decoder layer of a step): while a session runs, a ``record_function``
    of ``name``, so the trace names the host time inside it (a reader of
    the trace finds a near label where the step's span began thousands of
    operations earlier); otherwise a no-op context, at one flag test."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_LABEL


def profiler_on() -> bool:
    """Whether a ``torch.profiler`` session is recording."""
    return bool(_profiler._is_profiler_enabled)


class _Thread(threading.local):
    def __init__(self) -> None:
        self.spans: list = []       # the spans open on it, outermost first


_thread = _Thread()


class Span:
    """One timed block of host code: a context manager, or a decorator
    that opens a fresh span around each call. ``parent`` is the enclosing
    span on the thread unless one is given (a cause on another thread,
    such as the burst that admitted a request); ``root`` is the parent's
    root unless one is given; a span with neither is a root. ``id``,
    ``parent`` and ``root`` are set on entry; ``set`` adds attributes."""

    __slots__ = ("_store", "name", "attrs", "id", "parent", "root", "t0",
                 "_cause", "_of", "_child", "_rf", "_totals")

    def __init__(self, store: "Metrics", name: str,
                 parent: Optional["Span"] = None,
                 root: Optional["Span"] = None, **attrs):
        self._store, self.name, self.attrs = store, name, attrs
        self._cause, self._of = parent, root

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _place(self, stack: list) -> None:
        """Id, parent, root and the root's totals, from the thread's
        ``stack`` and the parent and root given."""
        self.id = next(_span_ids)
        p = self._cause
        if p is None and stack:
            p = stack[-1]
        self.parent = p.id if p is not None else 0
        of = self._of if self._of is not None else p
        if of is None:
            self.root = self.id
            self._totals = self._store._open_root(self)
        else:
            self.root, self._totals = of.root, of._totals

    def __enter__(self) -> "Span":
        stack = _thread.spans
        self._place(stack)
        self._child = 0
        stack.append(self)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        stack = _thread.spans
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        dur = t1 - self.t0
        if stack and stack[-1].id == self.parent:
            stack[-1]._child += dur
        self._store._close(self, t1, dur, dur - self._child)

    def __call__(self, fn):
        store, name, attrs = self._store, self.name, self.attrs

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with Span(store, name, **attrs):
                return fn(*args, **kwargs)
        return spanned


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class Metrics:
    """Thread-safe counters, latency windows and spans.

    One process-wide default instance (``metrics``); pipelines report phase
    walltimes, token counts and spans here so serving code can export them.
    """

    SPAN_RING = 1 << 16     # raw spans kept
    SPAN_ROOTS = 1024       # roots whose totals are kept

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._windows: Dict[str, Deque[float]] = {}
        self._totals: Dict[str, list] = {}     # name -> [calls, ns, self ns]
        self._ring: Deque[tuple] = deque(maxlen=self.SPAN_RING)
        self._roots: "OrderedDict[int, tuple]" = OrderedDict()

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
            if name in self._counters:
                return self._counters[name]
            return self._span_counters().get(name, 0.0)

    def _span_counters(self) -> Dict[str, float]:
        """Each span name's totals as counters (under the lock)."""
        out = {}
        for name, (calls, ns, self_ns) in self._totals.items():
            out[name + "_calls"] = float(calls)
            out[name + "_s"] = ns * 1e-9
            out[name + "_self_s"] = self_ns * 1e-9
        return out

    # -- spans -------------------------------------------------------------

    def span(self, name: str, parent: Optional[Span] = None,
             root: Optional[Span] = None, **attrs) -> Span:
        """A span of ``name`` (context manager or decorator) with small
        int ``attrs``; ``parent`` / ``root`` as ``Span`` says."""
        return Span(self, name, parent, root, **attrs)

    def record_span(self, name: str, t0_ns: int, t1_ns: int,
                    parent: Optional[Span] = None,
                    root: Optional[Span] = None, **attrs) -> None:
        """A span of an interval already past (``perf_counter_ns``
        stamps), for one that starts on one thread or call and ends on
        another: a request's wait in a queue, a stream chunk from its
        dispatch to its read. Its parent is the enclosing span on this
        thread unless one is given; it enters no profiler session."""
        s = Span(self, name, parent, root, **attrs)
        s._place(_thread.spans)
        s.t0 = t0_ns
        self._close(s, t1_ns, t1_ns - t0_ns, t1_ns - t0_ns)

    def _open_root(self, s: Span) -> dict:
        """Keep a new root (the oldest kept one goes past ``SPAN_ROOTS``);
        returns the dict its spans' totals go into."""
        totals: dict = {}
        with self._lock:
            self._roots[s.id] = (s.name, s.attrs, totals)
            if len(self._roots) > self.SPAN_ROOTS:
                self._roots.popitem(last=False)
        return totals

    def _close(self, s: Span, t1: int, dur: int, self_ns: int) -> None:
        name = s.name
        with self._lock:
            tot = self._totals.get(name)
            if tot is None:
                tot = self._totals[name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += self_ns
            tot = s._totals.get(name)
            if tot is None:
                tot = s._totals[name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += self_ns
            self._ring.append((s.id, s.parent, s.root, name, s.t0, t1,
                               s.attrs or None))

    def span_roots(self, name: Optional[str] = None) -> List[dict]:
        """The kept roots (of ``name``, if given), oldest first: {"id",
        "name", "attrs", "spans": {span name: {"calls", "s", "self_s"}}},
        the totals of every span under the root, the root's own too once
        it has closed."""
        with self._lock:
            return [{"id": rid, "name": rname, "attrs": dict(attrs),
                     "spans": {n: {"calls": c, "s": ns * 1e-9,
                                   "self_s": sns * 1e-9}
                               for n, (c, ns, sns) in totals.items()}}
                    for rid, (rname, attrs, totals) in self._roots.items()
                    if name is None or rname == name]

    def recent_spans(self) -> List[dict]:
        """The ring's spans, oldest first, in the order they closed."""
        with self._lock:
            ring = list(self._ring)
        return [{"id": i, "parent": p, "root": r, "name": n, "t0_ns": t0,
                 "t1_ns": t1, "attrs": dict(a or {})}
                for i, p, r, n, t0, t1, a in ring]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            out.update(self._span_counters())
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
            self._totals.clear()
            self._ring.clear()
            self._roots.clear()


metrics = Metrics()
span = functools.partial(Span, metrics)


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
