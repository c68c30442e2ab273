"""The two entries a cell's window can drive, chosen by the traffic file's
``entry``:

* ``batch``: ``TTSPipeline.process_batch`` in a closed loop, batch after
  batch, as ``cli/inference.py`` calls it (prefill, decode, vocode and the
  decode/vocode overlap of budgets past one codec window).
* ``server``: ``SpeechServer(scheduler="continuous")`` in this process on
  127.0.0.1 at a port the OS picks, two LoRA voices registered, and the
  open-loop streaming client (``client.py``) in a child process.

Each returns (result, the pipeline or None): the window's end-to-end
numbers, the samples the check judges, and (traced runs) what the
per-layer readers read. The served
tokens are taken where the program hands them on: the last result
``extract_codes`` sees in a batch, the row ``collect_async`` clones when
a pool request finishes.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import time
from typing import Optional

import numpy as np

from . import arch, client, program, traffic
from .reference.prompt import prompt_tokens
from .trace import Capture

STEP_LABEL = "ttsd_bench.step"


@dataclasses.dataclass
class Args:
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    quant: Optional[str] = "config"     # a control may override it
    rate: Optional[float] = None        # the sweep overrides the rate


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(device) -> int:
    import torch
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _row_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, 7, i])
               .generate_state(1, np.uint32)[0])


# ---------------------------------------------------------------------------
# batch: the offline dialogue path
# ---------------------------------------------------------------------------

def run_batch(a: Args) -> tuple:
    t = a.traffic
    pipe = program.build(a.cfg, a.seed, t["bucket"], a.device, a.quant)
    plan = traffic.batches(t, a.seed, t["max_batches"])
    seen = {}
    extract = pipe.extract_codes

    def extract_codes(result):
        seen["tokens"], seen["base"] = result.tokens, result.base
        return extract(result)
    pipe.extract_codes = extract_codes

    # warm-up: the cell's prompt shapes, a short decode, every codec
    # window bucket at the vocoder's rows per call
    warm = traffic.batches(t, a.seed + 1, 1)[0]
    pipe.process_batch([{"text": s} for s in warm["scripts"]],
                       max_new_tokens=t["warm_steps"], seed=1)
    spt = pipe.spt
    rows = pipe.vocode_rows_per_call or t["batch"]
    for n in sorted({-(-spt.chunk_codes * q // 4) for q in (1, 2, 3, 4)}):
        spt.decode([np.zeros((spt.nq, n), np.int64)] * rows,
                   overlap_seconds=pipe.vocode_overlap_s, pcm16=True,
                   rows_per_call=pipe.vocode_rows_per_call)
    probe = BatchProbe(pipe, t["trace_steps"]) if a.trace else None
    if probe is not None:
        probe.cap.warm()
    _sync(a.device)
    setup_s = time.perf_counter() - a.t_start
    _peak_reset(a.device)
    records = []
    t0 = time.perf_counter()
    for i, b in enumerate(plan):
        if i and time.perf_counter() - t0 >= a.seconds:
            break
        vocode0 = pipe.timings.vocode_s
        if probe is not None and i == 0:
            probe.begin()
        _, audio = pipe.process_batch([{"text": s} for s in b["scripts"]],
                                      max_new_tokens=b["steps"],
                                      seed=_row_seed(a.seed, i))
        records.append({
            "steps": b["steps"], "scripts": b["scripts"],
            "audio": [None if x is None else x["audio_data"][0]
                      for x in audio],
            "tokens": seen["tokens"], "base": seen["base"],
            "stats": dict(pipe.engine.last_stats),
            "vocode_s": pipe.timings.vocode_s - vocode0})
    _sync(a.device)
    wall = time.perf_counter() - t0
    peak = _peak(a.device)
    sr = spt.output_sample_rate
    audio_s = sum(len(x) / sr for r in records for x in r["audio"]
                  if x is not None)
    attempted = sum(len(r["audio"]) for r in records)
    failed = sum(x is None for r in records for x in r["audio"])
    layer = {}
    if probe is not None:
        layer = probe.finish(a.cfg, records)
    samples = _batch_samples(records)
    return {"e2e": {"rtf": audio_s / wall, "setup_s": setup_s},
            "attempted": attempted, "failed": failed, "peak": peak,
            "layer": layer, "samples": samples, "kind": "batch",
            "notes": {"batches": len(records), "audio_s": audio_s,
                      "wall_s": wall}}, pipe


def _batch_samples(records) -> list:
    """Every row that the window served: a fault confined to some rows of
    a batch (half of them, one slot) cannot miss the check."""
    return [{"script": rec["scripts"][j], "voice": None,
             "tokens": rec["tokens"][j], "base": rec["base"],
             "audio": rec["audio"][j]}
            for rec in records for j in range(len(rec["scripts"]))]


class BatchProbe:
    """The traced batch run: the device trace of the first batch's prefill
    and its first ``n`` decode steps, each step labelled; the window's
    batches' own counters (``last_stats``, the vocode time)."""

    def __init__(self, pipe, n: int):
        import torch
        self.n, self.cap, self.k = n, Capture(), 0
        eng = pipe.engine
        step = eng._step

        def traced_step(*args, **kw):
            if self.cap.prof is not None and self.k < self.n:
                with torch.profiler.record_function(STEP_LABEL):
                    step(*args, **kw)
                self.k += 1
                if self.k == self.n:
                    self.cap.stop()
                return None
            return step(*args, **kw)
        eng._step = traced_step

    def begin(self) -> None:
        """Start the trace before the window's first batch (the profiler's
        own start-up stays out of the engine's timers)."""
        self.cap.start()

    def finish(self, cfg: dict, records: list) -> dict:
        trace = self.cap.reduce(STEP_LABEL) if self.cap.done else {}
        work = arch.of(cfg)
        valid = [prompt_tokens(s) for s in records[0]["scripts"]]
        steps = []
        # the profiled batch's timers carry the profiler's cost: leave it
        # out when the window ran others
        for r in records[1:] if len(records) > 1 else records:
            st = r["stats"]
            pv = [prompt_tokens(s) for s in r["scripts"]]
            keys = [[v + s + 1 for v in pv] for s in range(st["steps"])]
            steps.append({"prefill_s": st["prefill_s"],
                          "decode_s": st["decode_s"], "steps": st["steps"],
                          "flops": sum(work.decode_flops(cfg, k)
                                       for k in keys),
                          "vocode_s": r["vocode_s"],
                          "audio_s": sum(len(x) / 24000.0 for x in r["audio"]
                                         if x is not None)})
        b2 = [work.decode_attention_work(cfg, [v + s + 1 for v in valid],
                                         len(valid), 2)
              for s in range(self.n)]
        return {"trace": trace, "batches": steps,
                "b1": work.b1_work(cfg, valid), "b2": b2}


# ---------------------------------------------------------------------------
# server: the streamed continuous pool
# ---------------------------------------------------------------------------

def run_server(a: Args) -> tuple:
    import torch
    from moss_ttsd_torch.serve.server import SpeechServer
    t = a.traffic
    rate = a.rate if a.rate is not None else t["rate_per_s"]
    pipe = program.build(a.cfg, a.seed, t["bucket"], a.device, a.quant)
    voices = program.voice_trees(a.cfg, a.seed, t["voices"], a.device)
    server = SpeechServer(pipe, host="127.0.0.1", port=0,
                          max_batch=t["slots"], scheduler="continuous",
                          pool_base=t["pool_base"],
                          pool_max_steps=t["pool_max_steps"],
                          segment_steps=t["segment_steps"],
                          pool_kv_quant=t["pool_kv_quant"],
                          lora_adapters=voices,
                          max_queue=t["max_queue"])
    del voices
    server.start()
    worker, cb = server.worker, server.worker.cb
    served = {}
    collected = {}
    collect, drain = cb.collect_async, worker._drain_finished

    def collect_async(j, steps=None):
        out = collect(j, steps)
        collected[j] = out[1]
        return out

    def drain_finished(done):
        reqs = {slot: worker._live.get(slot) for slot, _ in done}
        drain(done)
        for slot, _ in done:
            req, tok = reqs.get(slot), collected.pop(slot, None)
            if req is not None and tok is not None:
                served[req.seed] = tok
    cb.collect_async, worker._drain_finished = collect_async, drain_finished

    probe = PoolProbe(worker, a.cfg, t["trace_steps"]) if a.trace else None
    try:
        server.warmup(max_tokens=8)
        warm = traffic.requests(t, a.seed + 1, t["warm_requests"] / rate,
                                rate)
        for i, w in enumerate(warm):       # two bursts of short requests
            w["due"] = 0.0 if i < len(warm) // 2 else 0.5
            w["max_tokens"] = t["warm_frames"] + t["delay_steps"]
        client.run(server.port, warm, time.monotonic(), 120.0)
        _sync(a.device)
        served.clear()
        reqs = traffic.requests(t, a.seed, a.seconds, rate)
        if probe is not None:
            probe.arm(len(reqs))
        ctx = multiprocessing.get_context("spawn")
        here, there = ctx.Pipe()
        child = ctx.Process(target=client.main,
                            args=(there, server.port, reqs, t["drain_s"]))
        child.start()
        here.recv()                                  # the child is ready
        _peak_reset(a.device)
        t0 = time.monotonic() + 0.05
        setup_s = time.perf_counter() - a.t_start + 0.05
        here.send(t0)
        results = here.recv()
        child.join(30)
        if child.is_alive():
            child.terminate()
            child.join()
        peak = _peak(a.device)
    finally:
        server.stop()
    layer = probe.finish(a.cfg) if probe is not None else {}
    ttfa, gaps, late = [], [], []
    for req, res in zip(reqs, results):
        ok = (res.get("done") and res.get("status") == 200
              and res.get("chunks"))
        late.append(res.get("sent", float("inf")) - res.get("due", t0))
        if not ok:
            ttfa.append(float("inf"))
            continue
        ch = res["chunks"]
        ttfa.append((ch[0][0] - res["due"]) * 1e3)
        for i in range(1, len(ch) - 1):
            frames = ch[i][2] / 2 / 1920
            gaps.append((ch[i][0] - ch[i - 1][0]) * 1e3 / frames)
    failed = sum(1 for x in ttfa if x == float("inf"))
    third = max(1, len(ttfa) // 3)
    samples = _pool_samples(reqs, results, served, a.seed, t["check_requests"])
    del pipe
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"e2e": {"ttfa_p90_ms": traffic.percentile(ttfa, 90),
                    "frame_gap_p90_ms": traffic.percentile(gaps, 90),
                    "setup_s": setup_s},
            "attempted": len(reqs), "failed": failed, "peak": peak,
            "layer": layer, "samples": samples, "kind": "server",
            "notes": {"requests": len(reqs), "rate_per_s": rate,
                      "frame_gaps": len(gaps),
                      "late_max_s": max(late) if late else 0.0,
                      "late_p99_s": traffic.percentile(late, 99),
                      "ttfa_p50_ms": traffic.percentile(ttfa, 50),
                      "ttfa_p50_first_third_ms":
                          traffic.percentile(ttfa[:third], 50),
                      "ttfa_p50_last_third_ms":
                          traffic.percentile(ttfa[-third:], 50),
                      "frame_gap_p50_ms": traffic.percentile(gaps, 50),
                      "refused": sum(1 for r in results
                                     if r.get("status") == 429)}}, None


def _pool_samples(reqs, results, served, seed, n) -> list:
    """``n`` finished requests drawn from the seed, with the longest."""
    ok = [i for i, (q, r) in enumerate(zip(reqs, results))
          if r.get("done") and r.get("status") == 200 and q["seed"] in served]
    if not ok:
        return []
    r = np.random.default_rng([int(seed) % 2 ** 64, 4])
    longest = max(ok, key=lambda i: reqs[i]["frames"])
    rest = [i for i in ok if i != longest]
    picks = [longest] + [rest[int(k)] for k in r.permutation(len(rest))[:n - 1]]
    out = []
    for i in picks:
        q = reqs[i]
        out.append({"script": q["script"], "voice": q["voice"],
                    "tokens": served[q["seed"]].cpu().numpy(),
                    "base": None, "pcm": results[i]["pcm"],
                    "max_tokens": q["max_tokens"]})
    return out


class PoolProbe:
    """The traced server run: spans of admission (``submit`` to ``_join``),
    of each burst's prefill (``submit_many``, synced) and of each segment
    (``run``); the pool's rows followed on the host (prompt keys, steps
    done, budget), from which each step's FLOPs and attention bytes are
    counted after the window; and the device trace of ``n`` steps of the
    first segment after the window's last arrival."""

    def __init__(self, worker, cfg: dict, n: int):
        import torch
        cb = worker.cb
        self.cfg, self.k, self.n = cfg, None, n
        self.cap = Capture()
        self.waits, self.admits, self.runs = [], [], []
        self.rows = {}          # slot -> [prompt keys, steps done, budget]
        self.traced_rows = None  # the rows as the traced segment began
        self.kv_bytes = 1 if cb.cfg.kv_quant == "int8" else 2
        self.slots = cb.slots
        self.armed = False
        self.segment = 0
        self.step_in_segment = 0
        sent = {}
        submit, join = worker.submit, worker._join
        submit_many, run, step = cb.submit_many, cb.run, cb._step
        release, collect = cb.release, cb.collect_async

        def t_submit(req):
            sent[id(req)] = time.perf_counter()
            if self.armed:
                self.submitted += 1
            return submit(req)

        def t_join(req, slot):
            t0 = sent.pop(id(req), None)
            if t0 is not None and self.armed:
                self.waits.append(time.perf_counter() - t0)
            return join(req, slot)

        def t_submit_many(requests):
            t0 = time.perf_counter()
            slots = submit_many(requests)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            if self.armed:
                self.admits.append(time.perf_counter() - t0)
            for req, j in zip(requests, slots):
                budget = cb._resolve_steps(req[0], req[1])
                self.rows[j] = [req[0].shape[0] - cb.cfg.channels + 1, 0,
                                budget]
            return slots

        def t_run(steps=25):
            if not self.armed:
                if not self.cap.warmed:     # the profiler's start-up cost
                    self.cap.warm()         # in the thread that traces
                done = run(steps)
                self._advance(done)
                return done
            self.segment += 1
            self.step_in_segment = 0
            if self.k is None and self.submitted >= self.expected:
                self.k = self.segment       # trace this segment
                self.traced_rows = [list(r) for r in self.rows.values()]
            rows = [tuple(r) for r in self.rows.values()]
            t0 = time.perf_counter()
            done = run(steps)
            if self.segment != self.k:      # the profiled segment is not
                self.runs.append(           # timed with the others
                    (time.perf_counter() - t0, done, rows))
            self._advance(done)
            return done

        def t_step():
            if self.armed and self.segment == self.k and self.cap.prof is None \
                    and not self.cap.done and self.step_in_segment == 2:
                self.cap.start()
            if self.cap.prof is not None and not self.cap.done:
                with torch.profiler.record_function(STEP_LABEL):
                    step()
                self.step_in_segment += 1
                if self.step_in_segment == 2 + self.n:
                    self.cap.stop()
                return
            step()
            self.step_in_segment += 1

        def t_release(j):
            self.rows.pop(j, None)
            return release(j)

        def t_collect(j, steps=None):
            self.rows.pop(j, None)
            return collect(j, steps)

        worker.submit, worker._join = t_submit, t_join
        cb.submit_many, cb.run, cb._step = t_submit_many, t_run, t_step
        cb.release, cb.collect_async = t_release, t_collect

    def _advance(self, done: int) -> None:
        for row in self.rows.values():
            row[1] = min(row[2], row[1] + done)

    @staticmethod
    def _keys(rows, j: int) -> list:
        """The attention keys of each row that advances at a segment's
        j-th step, rows as (prompt keys, steps done, budget) at its start."""
        return [p + k + j + 1 for p, k, b in rows if k + j < b]

    def arm(self, expected: int) -> None:
        """Start recording: the window begins. The device trace is taken
        in the first segment after the window's ``expected`` requests have
        all arrived (the pool still at its load): stopping the profiler
        holds the worker thread for seconds, which then delays no
        admission that a span measures."""
        self.expected, self.submitted, self.k = expected, 0, None
        self.armed = True

    def finish(self, cfg: dict) -> dict:
        trace = self.cap.reduce(STEP_LABEL) if self.cap.done else {}
        work = arch.of(cfg)
        runs = [(dt, done, sum(work.decode_flops(cfg, self._keys(rows, j))
                               for j in range(done)))
                for dt, done, rows in self.runs]
        b3 = []
        if self.traced_rows is not None:
            for j in range(2, 2 + self.n):
                keys = self._keys(self.traced_rows, j)
                b3.append(work.decode_attention_work(
                    cfg, keys + [1] * (self.slots - len(keys)), self.slots,
                    self.kv_bytes))
        return {"trace": trace, "join_waits": self.waits,
                "admits": self.admits, "runs": runs, "b3": b3}


ENTRIES = {"batch": run_batch, "server": run_server}
