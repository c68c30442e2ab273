"""The routed experts of the AFMoE block (``models/lm.AFMoEBlock``): the
router, and the grouped product over the experts held here.

  * ``route``: sigmoid scores of the router's product (taken in the compute
    dtype, the sigmoid in fp32), the top-k of score + bias, and weights
    ``route_scale * s_e`` (over the sum of the chosen scores with
    ``route_norm``): the bias chooses, it does not weigh.
  * ``moe_experts``: each token's sum over its chosen experts that are held
    here, experts [offset, offset + E): w * down(silu(gate x) * up x). A
    pair routed to an expert not held is dropped (expert parallelism: the
    chip that holds it adds it; nothing here stands in for it).

``moe_experts`` of a CUDA tensor runs ``csrc/moe_experts.cu``: at most
``KERNEL_ROWS`` tokens (a decode step) the weight-streaming kernel, more (a
prefill) the grouped GEMM, which sorts the pairs by expert on the device.
Both launch a grid fixed by the shapes and read nothing back to the host,
so a captured step replays either. A shape neither takes raises; the CPU
takes ``moe_experts_plain`` (tokens sorted by expert, the held experts'
products one after another, one host read of the counts), which is also
the kernels' oracle on the card. All three compute the same function:
gate and up products in fp32, their SwiGLU rounded to x's type, the down
product in fp32 times the pair's weight, and each token's pairs summed in
slot order in fp32, rounded to x's type.

``counts`` (a (3,) int64 tensor on x's device), when given, gains the held
(token, expert) pairs, the distinct held experts read and one call, on the
device (the kernel's own grouping counts them): the engine publishes them
as ``moe_pairs_held``, ``moe_experts_read`` and ``moe_calls``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import flash_attention as fa
from .w8a16 import matmul_f32_out as mm32

KERNEL_ROWS = 256       # the decode kernel's most tokens (csrc MAX_ROWS)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def route(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float, norm: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (N, H) -> (idx (N, top_k) int64 expert ids, w (N, top_k) fp32).
    s = sigmoid(h router^T) in fp32 from the product in h's dtype; the
    experts of the top-k of s + bias (the bias shifts the choice only);
    w = scale * s_e, over the chosen s's sum when ``norm``."""
    s = torch.sigmoid(F.linear(h, weight.to(h.dtype)).float())
    idx = torch.topk(s + bias.float(), top_k, dim=-1).indices
    sel = s.gather(-1, idx)
    if norm:
        sel = sel / sel.sum(dim=-1, keepdim=True)
    return idx, sel * scale


def moe_experts_plain(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      gate: torch.Tensor, up: torch.Tensor,
                      down: torch.Tensor, offset: int,
                      counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``moe_experts`` (its oracle and the CPU's path):
    the pairs sorted by held expert, each expert's tokens
    through its SwiGLU in turn. x (N, H); idx, w (N, k); gate, up (E, I, H);
    down (E, H, I). Returns (N, H) in x's type."""
    N, H = x.shape
    k, E = idx.shape[1], gate.shape[0]
    local = idx - offset
    held = (local >= 0) & (local < E)
    flat = torch.where(held, local, E).reshape(-1)     # E: not held here
    order = torch.argsort(flat, stable=True)
    per = torch.bincount(flat, minlength=E + 1)
    y = torch.zeros(N * k, H, dtype=torch.float32, device=x.device)
    wf = w.reshape(-1).float()
    start = 0
    for e, n in enumerate(per[:E].tolist()):
        if n:
            pairs = order[start:start + n]
            xe = x[pairs // k]
            act = (F.silu(mm32(xe, gate[e].t())) * mm32(xe, up[e].t()))
            y[pairs] = mm32(act.to(x.dtype), down[e].t()) * wf[pairs, None]
        start += n
    y = y.reshape(N, k, H)
    out = torch.zeros(N, H, dtype=torch.float32, device=x.device)
    for j in range(k):              # slot order, as the kernel sums
        out = out + y[:, j]
    if counts is not None:
        counts += torch.stack([held.sum(), (per[:E] > 0).sum(),
                               torch.ones_like(per[0])])
    return out.to(x.dtype)


def moe_experts(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                offset: int, counts: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Each token's weighted sum over its held experts (module docstring).
    x (N, H) fp32 or bf16, rows 16-byte aligned; idx (N, k) int64; w (N, k)
    fp32; gate, up (E, I, H) and down (E, H, I) in x's type, contiguous;
    ``counts`` (3,) int64. On the card, N <= ``KERNEL_ROWS`` runs the
    decode kernel, more the grouped GEMM."""
    N, H = x.shape
    if idx.shape != w.shape or idx.shape[0] != N:
        raise ValueError(f"moe_experts: idx {tuple(idx.shape)}, w "
                         f"{tuple(w.shape)} for {N} tokens")
    E, I = gate.shape[0], gate.shape[1]
    if (gate.shape != (E, I, H) or up.shape != gate.shape
            or down.shape != (E, H, I)):
        raise ValueError(f"moe_experts: gate {tuple(gate.shape)}, up "
                         f"{tuple(up.shape)}, down {tuple(down.shape)} for "
                         f"hidden {H}")
    if not x.is_cuda:
        return moe_experts_plain(x, idx, w, gate, up, down, offset, counts)
    what = "moe_experts"
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {x.dtype} not supported")
    for name, t in (("gate", gate), ("up", up), ("down", down)):
        if t.dtype != x.dtype or t.device != x.device or not \
                t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{x.dtype} tensor on {x.device}")
    if x.stride(1) != 1:
        raise ValueError(f"{what}: x must be contiguous in its last dim")
    fa._check_rows_16b(x, what, "x")
    idx = idx.to(torch.int64).contiguous()
    w = w.to(torch.float32).contiguous()
    if counts is not None and (counts.dtype != torch.int64
                               or counts.shape != (3,)
                               or counts.device != x.device):
        raise ValueError(f"{what}: counts must be a (3,) int64 tensor on "
                         f"{x.device}")
    k = idx.shape[1]
    lib = fa.build_kernels()["moe_experts"]
    act = torch.empty((N * k, I), dtype=x.dtype, device=x.device)
    ybuf = torch.empty((N * k, H), dtype=torch.float32, device=x.device)
    out = torch.empty((N, H), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tail = (None if counts is None else counts.data_ptr(), N, k, H, I, E,
            int(offset), x.stride(0), out.stride(0), stream)
    head = (_DTYPE_CODE[x.dtype], x.data_ptr(), idx.data_ptr(), w.data_ptr(),
            gate.data_ptr(), up.data_ptr(), down.data_ptr())
    if N <= KERNEL_ROWS:
        rc = lib.moss_moe_experts(*head, act.data_ptr(), ybuf.data_ptr(),
                                  out.data_ptr(), *tail)
    else:
        perm = torch.empty(N * k, dtype=torch.int32, device=x.device)
        meta = torch.empty(2 * (E + 1), dtype=torch.int32, device=x.device)
        rc = lib.moss_moe_experts_grouped(
            *head, perm.data_ptr(), meta.data_ptr(), act.data_ptr(),
            ybuf.data_ptr(), out.data_ptr(), *tail)
    fa._check_rc(rc, what)
    fa._count(moe_experts)
    return out


fa.count_launches(moe_experts)
