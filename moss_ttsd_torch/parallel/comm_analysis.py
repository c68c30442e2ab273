"""Communication accounting, PyTorch port of
``moss_ttsd_tpu/parallel/comm_analysis.py``.

Two complementary views, as in the JAX package:

1. ``collective_inventory(prof)`` — what a run really issued: every
   collective the process-group backend (gloo or NCCL) ran, read from a
   ``torch.profiler`` trace of the run, with its payload bytes (from the
   shapes and dtypes the profiler recorded) and whether it fell inside a
   named per-step region (``torch.profiler.record_function(step_region)``
   around each decode step or train step) — JAX's ``per_step`` — or
   outside every such region (``per_call``). JAX reads the same from the
   compiled HLO; here the collectives are explicit calls
   (``parallel/mesh.py``), and ``Mesh.collectives`` counts them on the
   host as a cross-check.

2. ``tp_decode_cost_model(cfg, ...)`` — an analytic cost model of one
   tensor-parallel decode step at the full serving geometry, next to a
   measured single-card step: which collectives the layout needs, their
   wire bytes, and at which tensor-parallel size the split pays. The
   formulas are JAX's; the hardware is an argument (``Hardware``). Its
   default holds the public NVIDIA H100 SXM figures (the H100 datasheet:
   HBM3 3.35 TB/s; fourth-generation NVLink 900 GB/s a card, 450 GB/s in
   each direction). The per-collective latency has no datasheet figure:
   5 us is the order of NCCL's small-message latency inside one NVLink
   node, a placeholder that no run here has measured. The step times have
   no default: the caller passes the card's measured step.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple


class Hardware(NamedTuple):
    name: str = "H100 SXM"
    hbm_gbps: float = 3350.0     # HBM3, H100 SXM datasheet
    link_gbps: float = 450.0     # NVLink 4: 900 GB/s a card, 450 a direction
    collective_us: float = 5.0   # per-collective latency (order of; unmeasured)


H100_SXM = Hardware()

# element bytes by the dtype names the profiler records
_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
    "int": 4, "long int": 8, "short int": 2, "signed char": 1,
    "unsigned char": 1, "bool": 1, "c10::complex<float>": 8,
}
_BACKENDS = ("gloo", "nccl")
# backend op names (gloo:all_reduce, nccl:_allgather_base, nccl:send 0->1,
# ...) -> the inventory's kinds, first match wins
_KINDS = (("barrier", "barrier"), ("all_reduce", "all_reduce"),
          ("allreduce", "all_reduce"), ("all_gather", "all_gather"),
          ("allgather", "all_gather"), ("reduce_scatter", "reduce_scatter"),
          ("all_to_all", "all_to_all"), ("alltoall", "all_to_all"),
          ("broadcast", "broadcast"), ("send", "send"), ("recv", "recv"))


class CollectiveOp(NamedTuple):
    kind: str          # all_reduce | all_gather | broadcast | send | ...
    bytes: int         # payload: the backend op's recorded tensors
    computation: str   # the step region the op ran in ("" outside one)
    per_step: bool     # inside a step region => runs once per step


def _kind(name: str) -> Optional[str]:
    backend, _, op = name.partition(":")
    if backend not in _BACKENDS or not op:
        return None
    op = op.split()[0].lstrip("_")
    for key, kind in _KINDS:
        if key in op:
            return kind
    return None


def _event_bytes(shapes, dtypes) -> int:
    total = 0
    for shape, dtype in zip(shapes, dtypes):
        if dtype not in _DTYPE_BYTES or not isinstance(shape, (list, tuple)):
            continue
        n = 1
        for d in shape:
            n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_events(prof, step_region: str = "step"
                      ) -> List[Tuple[CollectiveOp, float]]:
    """Every backend collective of a stopped ``torch.profiler.profile``
    (``ProfilerActivity.CPU`` and ``record_shapes=True``) with its host
    duration in microseconds (for gloo the transfer through the host; for
    NCCL the enqueue), in start order.

    An op is per-step when it started inside an event named
    ``step_region`` (on any thread: gloo runs its work on threads of its
    own). The payload is the backend op's recorded tensors: the operand
    of an all-reduce, a broadcast or a send, this rank's part of an
    all-gather (JAX counts the gathered result there). gloo runs a
    reduce-scatter as an all-reduce and records it so."""
    events = list(prof.profiler.kineto_results.events())
    regions = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in events if e.name() == step_region]
    out = []
    for e in sorted(events, key=lambda e: e.start_ns()):
        kind = _kind(e.name())
        if kind is None:
            continue
        t = e.start_ns()
        inside = any(a <= t < b for a, b in regions)
        op = CollectiveOp(kind=kind, bytes=_event_bytes(e.shapes(),
                                                        e.dtypes()),
                          computation=step_region if inside else "",
                          per_step=inside)
        out.append((op, e.duration_ns() / 1e3))
    return out


def collective_inventory(prof, step_region: str = "step"
                         ) -> List[CollectiveOp]:
    """The collectives of a profiled run (``collective_events``)."""
    return [op for op, _ in collective_events(prof, step_region)]


def profile_decode_steps(engine, input_ids, attention_mask, steps: int = 2,
                         step_region: str = "decode_step"):
    """Profile one request on ``engine`` (a ``decode.engine.
    GenerationEngine``, on a mesh or not): its prefill, then ``steps``
    decode steps each inside ``record_function(step_region)``, under
    ``torch.profiler`` (CPU activity, shapes recorded), greedy or seeded
    from 0. Returns (the stopped profile, the collectives the engine's
    mesh counted over the steps; 0 without a mesh)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    mesh = engine.mesh
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        st, base, _, _, gen, *_, ad = engine._start(
            input_ids, attention_mask, steps, 0, None)
        c0 = 0 if mesh is None else mesh.collectives
        for _ in range(steps):
            with record_function(step_region):
                engine._step(st, base, gen, ad)
        counted = 0 if mesh is None else mesh.collectives - c0
    return prof, counted


def summarize_inventory(ops: List[CollectiveOp]) -> Dict[str, Dict]:
    """{'per_step': {kind: (count, bytes)}, 'per_call': {...}}"""
    out = {"per_step": {}, "per_call": {}}
    for op in ops:
        bucket = out["per_step" if op.per_step else "per_call"]
        cnt, byt = bucket.get(op.kind, (0, 0))
        bucket[op.kind] = (cnt + 1, byt + op.bytes)
    return out


def format_inventory(name: str, ops: List[CollectiveOp]) -> str:
    s = summarize_inventory(ops)
    parts = [f"[comm] {name}:"]
    for scope in ("per_step", "per_call"):
        if not s[scope]:
            continue
        items = ", ".join(f"{cnt}x {kind} ({byt / 1024:.1f} KiB)"
                          for kind, (cnt, byt) in sorted(s[scope].items()))
        parts.append(f"  {scope}: {items}")
    if len(parts) == 1:
        parts.append("  (no collectives)")
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# Analytic TP decode cost model at the full serving geometry
# ---------------------------------------------------------------------------

class TpCost(NamedTuple):
    tp: int
    comm_bytes: int        # wire bytes per decode step (all axes)
    n_collectives: int     # collectives per decode step
    comm_us: float         # predicted link time per step
    weight_us: float       # per-card weight-streaming time (the HBM floor)
    step_us: float         # predicted step = weights/tp-shard + fixed + comm
    speedup: float         # vs the measured single-card step


def weight_bound_us(weight_bytes: int, hardware: Hardware = H100_SXM
                    ) -> float:
    """The time to stream ``weight_bytes`` once from HBM, in us."""
    return weight_bytes / (hardware.hbm_gbps * 1e3)


def tp_decode_cost_model(cfg, batch: int, single_chip_step_us: float,
                         weight_bound_us: float, tp_sizes=(2, 4, 8),
                         weight_bytes: Optional[int] = None,
                         restricted_head: bool = False,
                         hardware: Hardware = H100_SXM) -> List[TpCost]:
    """Predict the TP decode-step time on ``hardware``'s links at the full
    LM geometry (JAX's model, its formulas unchanged).

    The decode step is weight-bandwidth-bound: ``weight_bound_us`` is the
    backbone + attention share of the measured single-card step
    ``single_chip_step_us``, which TP divides by N (each card streams 1/N
    of every sharded matmul's weights); the remainder (sampling, the
    logits head's fixed costs) stays per card. Comm per step, from the
    layout ``parallel/mesh.lm_param_specs`` uses (colwise q/k/v/gate/up,
    rowwise o/down, the vocab-sharded tied text head):

      * 2 all-reduces of the (B, 1, hidden) bf16 activations per layer
        (after o_proj and after down_proj),
      * 1 all-reduce of (B, 1, hidden) for the vocab-sharded embedding
        lookup,
      * 1 all-gather of the channel-0 logits (B, window) fp32 — the full
        152k vocab unless restricted_head.

    Wire bytes use ring costs: all-reduce = 2*(N-1)/N * payload,
    all-gather = (N-1)/N * payload, over ``hardware.link_gbps``, plus
    ``hardware.collective_us`` a collective. ``weight_bytes`` is accepted
    for JAX's signature and unused, as there."""
    H = cfg.hidden_size
    L = cfg.num_hidden_layers
    V = (cfg.text_head_window()[1] - cfg.text_head_window()[0]
         if restricted_head else cfg.vocab_size)
    out: List[TpCost] = []
    for n in tp_sizes:
        ar_payload = batch * H * 2                     # bf16 activations
        ag_payload = batch * V * 4                     # fp32 logits
        n_ar = 2 * L + 1
        wire = (n_ar * 2 * (n - 1) / n * ar_payload
                + (n - 1) / n * ag_payload)
        n_coll = n_ar + 1
        comm_us = (wire / (hardware.link_gbps * 1e3)   # bytes / (GB/s) -> us
                   + n_coll * hardware.collective_us)
        fixed_us = single_chip_step_us - weight_bound_us
        step_us = weight_bound_us / n + fixed_us + comm_us
        out.append(TpCost(tp=n, comm_bytes=int(wire), n_collectives=n_coll,
                          comm_us=comm_us, weight_us=weight_bound_us / n,
                          step_us=step_us,
                          speedup=single_chip_step_us / step_us))
    return out


def format_tp_cost_table(costs: List[TpCost], batch: int,
                         restricted_head: bool = False,
                         hardware: Hardware = H100_SXM) -> str:
    head = ("[comm] %s TP decode cost model @B%d%s "
            "(measured 1-chip step %.2f ms):"
            % (hardware.name, batch,
               " restricted-head" if restricted_head else "",
               costs[0].step_us * costs[0].speedup / 1000.0))
    rows = [head]
    for c in costs:
        rows.append(
            f"  TP={c.tp}: {c.n_collectives} collectives/step, "
            f"{c.comm_bytes / 1024:.0f} KiB wire -> {c.comm_us:.0f} us comm; "
            f"step {c.step_us / 1000:.2f} ms, {c.speedup:.2f}x 1 chip "
            f"({c.speedup / c.tp:.2f}x per-chip efficiency)")
    return "\n".join(rows)
