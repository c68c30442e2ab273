"""The static engine's captured decode step: past the teacher-forcing
window, each step of ``GenerationEngine`` is one replay of a CUDA graph of
the whole step (logits, draw, flags and the forward with its decode
kernels), in place of its ~2000 eager launches.

A graph is keyed on what fixes its addresses and shapes: (rows, capacity
S); the KV cache's dtype is the engine's. Each key owns a workspace, a
decode state's tensors (token buffer, cache, ``key_valid``, presence sets,
flags, the last hidden state and positions, and the write slot ``pos`` that
the graph advances), and a generator registered with its graph. A request
of the key is prefilled into the workspace itself, so it holds one KV
cache, as an eager request does: nothing is copied in but the small fields
the prefill computes. The key is captured when its first request starts:
two eager warm-up steps on the workspace, still unfilled, on the graph's
own stream (the split decode's ticket counters are a stream's), then the
capture into the graph's own memory pool. The engine keeps the most recent
key; a state keeps the graph it is bound to. One state holds a workspace
at a time: a second live request of the key decodes eagerly.

``StepGraphs.take`` runs under a lock, so two threads serving one engine
(the server's batch worker and its stream handler) never capture at once
or bind one workspace twice. The decode wrappers' counters
(``flash_attention.launch_counts``) count a replay's captured calls; the
warm-up and the capture are recorded on their own thread only and not
counted. The registry (``utils/profiling.metrics``) counts
``engine_graph_captures`` and times each capture as the span
``engine.capture``.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional

import torch

from ..ops import flash_attention as fa
from ..utils.profiling import metrics, span

# the state's tensors that a step reads or writes, the cache aside (written
# in place, never rebound); the audit counters stay the request's own (only
# eager steps touch them)
FIELDS = ("tokens", "key_valid", "hidden_last", "last_pos", "needs",
          "unfinished", "presence_text", "presence_speech", "pos")
WARMUP_STEPS = 2


def hold(st, fixed: Dict[str, torch.Tensor]) -> None:
    """Copy each field of ``st`` that is not its ``fixed`` tensor (one the
    step rebound) into that tensor, and bind it back: the tensors a
    captured step reads stay the state's."""
    for name, w in fixed.items():
        t = getattr(st, name)
        if t is not w:
            w.copy_(t)
            setattr(st, name, w)


class StepGraph:
    """One key's workspace, generator and captured step."""

    def __init__(self, engine, rows: int, slots: int):
        self.engine = engine
        self.key = (rows, slots)
        self.ws = engine._empty_state(rows, slots)
        self.fixed = {n: getattr(self.ws, n) for n in FIELDS}
        self.gen = torch.Generator(device=engine.device)
        self.busy = False
        self.launches = self._capture()

    def _body(self) -> None:
        """The step past the teacher-forcing window (every mask fixed) on
        the workspace, the write slot on the device."""
        eng, ws = self.engine, self.ws
        tokens = eng._sample(ws, eng.cfg.channels - 1, self.gen)
        eng._forward(ws, tokens, ws.pos)
        hold(ws, self.fixed)

    def _capture(self) -> Dict[str, int]:
        """Warm up on the graph's stream (handles, workspaces and the split
        decode's ticket counters of that stream), then capture; returns
        the decode wrappers' calls a replay makes."""
        dev = self.engine.device
        self.stream = torch.cuda.Stream(dev)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.gen)
        main = torch.cuda.current_stream(dev)
        self.stream.wait_stream(main)
        with fa.recording_launches(), torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                self._body()
        main.wait_stream(self.stream)
        with fa.recording_launches() as calls, torch.cuda.graph(
                self.graph, stream=self.stream,
                capture_error_mode="thread_local"):
            self._body()
        return calls

    def bind(self, st, gen: torch.Generator) -> None:
        """Bind a state prefilled into the workspace: its small fields
        copied in, the workspace's generator at ``gen``'s seed and offset
        (so the replayed draws are the eager step's), the workspace free
        again when the state dies."""
        if st.cache is not self.ws.cache:
            raise ValueError("bind a state prefilled into the workspace")
        hold(st, self.fixed)
        self.gen.set_state(gen.get_state())
        st.graph = self
        weakref.finalize(st, self.release)

    def release(self) -> None:
        self.busy = False

    def replay(self) -> None:
        self.graph.replay()
        fa.add_launch_counts(self.launches)


class StepGraphs:
    """An engine's captured steps: the most recent key is kept (a state
    keeps the graph it is bound to)."""

    def __init__(self, engine):
        self.engine = weakref.proxy(engine)     # no cycle through the engine
        self._lock = threading.Lock()
        self.kept: Optional[StepGraph] = None

    def take(self, rows: int, slots: int) -> Optional[StepGraph]:
        """The key's step, free and marked busy (captured first if the key
        is not the kept one, which it replaces), or None while a live
        state holds it."""
        with self._lock:
            g = self.kept
            if g is not None and g.key == (rows, slots):
                if g.busy:
                    return None
            else:
                self.kept = None        # its memory is free for the new key
                with span("engine.capture", rows=rows, slots=slots):
                    g = StepGraph(self.engine, rows, slots)
                metrics.add("engine_graph_captures")
                self.kept = g
            g.busy = True
            return g
