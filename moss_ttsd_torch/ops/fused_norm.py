"""The elementwise glue between a decoder block's projections: RMSNorm, the
residual adds around it, the per-head q/k RMSNorm with RoPE, and the
SwiGLU product, each as one Hopper kernel (``csrc/fused_norm.cu``) with
its plain PyTorch version beside it.

  * ``residual_rms_norm(x, y, w, eps, w_y)`` -> (x', h): x' = x + y, or
    x + RMSNorm(y; w_y) when ``w_y`` is given (the AFMoE block's sandwich
    norms), and h = RMSNorm(x'; w). ``y`` None: x' is x and h its norm
    (``input_ln``, ``final_norm``); ``w`` None: h is None (the AFMoE
    block's last residual add).
  * ``qk_norm_rope(q, k, w_q, w_k, eps, cos, sin, rope)`` -> (q, k): the
    per-head RMSNorm of q (B, T, H, D) and k (B, T, Hkv, D), then
    rotate-half RoPE (``ops/rope.apply_rope``) on both when ``rope``.
  * ``silu_mul(gate, up)``: silu(gate) * up.

The ``*_plain`` versions are the chains of PyTorch ops the blocks ran
before the kernels, rounding where they round (``rms_norm_fn``,
``apply_rope``, the adds in the input's type); they are the CPU's path,
the cache-free forward's (autograd runs through them) and the kernels'
oracle. The kernels keep every rounding point and differ from the plain
versions only in the order of the fp32 reductions. The plain versions
also take ``ablate``, the bench-only ``cfg.ablate_norms`` stub (every
RMSNorm is ``x * w``); the blocks choose between the two
(``models/lm.block_glue``).

A CUDA tensor of bf16 or fp32 launches the kernel, on the current stream
with no host read (a CUDA graph captures it), or the wrapper raises; each
wrapper counts its launches in ``<wrapper>.launches``
(``flash_attention``'s counters: a capture records them, each replay adds
them).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import flash_attention as fa
from .rope import apply_rope

MAX_ROW = 4 * 1024          # 16-byte vectors in one row (csrc MAX_THREADS x 4)
MAX_HEAD_DIM = 256


def rms_norm_fn(x: torch.Tensor, w: torch.Tensor, eps: float,
                ablate: bool = False) -> torch.Tensor:
    """RMSNorm with fp32 statistics, cast back to the input dtype before the
    weight multiply (as the JAX ``rms_norm_fn``). ``ablate`` (the bench-only
    ``cfg.ablate_norms`` stub) is ``x * w`` in x's dtype."""
    if ablate:
        return x * w.to(x.dtype)
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * w.to(x.dtype)


def residual_rms_norm_plain(x: torch.Tensor, y: Optional[torch.Tensor],
                            w: Optional[torch.Tensor], eps: float,
                            w_y: Optional[torch.Tensor] = None,
                            ablate: bool = False
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of ``residual_rms_norm``."""
    if y is not None:
        x = x + (y if w_y is None else rms_norm_fn(y, w_y, eps, ablate))
    return x, None if w is None else rms_norm_fn(x, w, eps, ablate)


def qk_norm_rope_plain(q: torch.Tensor, k: torch.Tensor, w_q: torch.Tensor,
                       w_k: torch.Tensor, eps: float, cos: torch.Tensor,
                       sin: torch.Tensor, rope: bool = True,
                       ablate: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``qk_norm_rope``."""
    q, k = rms_norm_fn(q, w_q, eps, ablate), rms_norm_fn(k, w_k, eps, ablate)
    if rope:
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k


def silu_mul_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Plain version of ``silu_mul``."""
    return F.silu(gate) * up


def _dtype_code(what: str, t: torch.Tensor) -> int:
    if t.dtype not in fa._DTYPE_CODE:
        raise ValueError(f"{what}: no kernel takes {t.dtype} (float32, "
                         "bfloat16)")
    return fa._DTYPE_CODE[t.dtype]


def _same(what: str, ref: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and (t.device != ref.device or t.dtype != ref.dtype):
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"x is {ref.dtype} on {ref.device}")


def _rows(what: str, name: str, t: torch.Tensor, N: int) -> torch.Tensor:
    """t as (rows, N) with 16-byte aligned rows, contiguous in N."""
    t2 = t.reshape(-1, N)
    if t2.stride(1) != 1:
        raise ValueError(f"{what}: {name} must be contiguous in its last dim")
    fa._check_rows_16b(t2, what, name)
    return t2


def residual_rms_norm(x: torch.Tensor, y: Optional[torch.Tensor],
                      w: Optional[torch.Tensor], eps: float,
                      w_y: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x' = x + (y, or RMSNorm(y; w_y)) and h = RMSNorm(x'; w) over the last
    dim of x (..., N) in one launch (module docstring): y like x or None,
    w / w_y (N,) or None (cast to x's type, as the plain version casts
    them). Returns (x', h); x' is x itself when y is None, h None when w
    is. CPU tensors take ``residual_rms_norm_plain``."""
    if not x.is_cuda:
        return residual_rms_norm_plain(x, y, w, eps, w_y)
    what = "residual_rms_norm"
    if y is None and w is None:
        raise ValueError(f"{what}: neither an addend nor a norm weight")
    N = x.shape[-1]
    code = _dtype_code(what, x)
    w, w_y = (None if t is None else t.to(x.dtype) for t in (w, w_y))
    _same(what, x, y=y, w=w, w_y=w_y)
    if y is not None and y.shape != x.shape:
        raise ValueError(f"{what}: y {tuple(y.shape)} for x {tuple(x.shape)}")
    vec = 16 // x.element_size()
    if N % vec or N // vec > MAX_ROW:
        raise ValueError(f"{what}: a row of {N} must be a multiple of {vec} "
                         f"and at most {MAX_ROW * vec} values")
    x2 = _rows(what, "x", x, N)
    y2 = None if y is None else _rows(what, "y", y, N)
    for name, t in (("w", w), ("w_y", w_y)):
        if t is not None:
            if t.shape != (N,):
                raise ValueError(f"{what}: {name} {tuple(t.shape)} for rows "
                                 f"of {N}")
            _rows(what, name, t, N)
    xo = None if y is None else torch.empty(x.shape, dtype=x.dtype,
                                            device=x.device)
    ho = None if w is None else torch.empty(x.shape, dtype=x.dtype,
                                            device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = fa.build_kernels()["fused_norm"].moss_residual_rms_norm(
        code, x2.shape[0], N, eps, x2.data_ptr(), x2.stride(0), ptr(y2),
        0 if y2 is None else y2.stride(0), ptr(None if y is None else w_y),
        ptr(w), ptr(xo), N, ptr(ho), N,
        torch.cuda.current_stream(x.device).cuda_stream)
    fa._check_rc(rc, what)
    fa._count(residual_rms_norm)
    return (x if xo is None else xo), ho


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, w_q: torch.Tensor,
                 w_k: torch.Tensor, eps: float, cos: torch.Tensor,
                 sin: torch.Tensor, rope: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-head RMSNorm of q (B, T, H, D) and k (B, T, Hkv, D) with
    w_q / w_k (D,), then (``rope``) rotate-half RoPE by cos / sin (B, T, D)
    fp32 (``ops/rope.rope_cos_sin``; a batch of 1 broadcasts), in one
    launch. Returns new contiguous (q, k) in q's type. CPU tensors take
    ``qk_norm_rope_plain``."""
    if not q.is_cuda:
        return qk_norm_rope_plain(q, k, w_q, w_k, eps, cos, sin, rope)
    what = "qk_norm_rope"
    code = _dtype_code(what, q)
    B, T, H, D = q.shape
    w_q, w_k = w_q.to(q.dtype), w_k.to(q.dtype)
    _same(what, q, k=k, w_q=w_q, w_k=w_k)
    if k.dim() != 4 or k.shape[:2] != (B, T) or k.shape[3] != D:
        raise ValueError(f"{what}: k {tuple(k.shape)} for q {tuple(q.shape)}")
    if D % 2 or D > MAX_HEAD_DIM or w_q.shape != (D,) or w_k.shape != (D,):
        raise ValueError(f"{what}: head_dim {D} (even, at most "
                         f"{MAX_HEAD_DIM}) with weights of {D}")
    if q.stride(3) != 1 or k.stride(3) != 1 or w_q.stride(0) != 1 \
            or w_k.stride(0) != 1:
        raise ValueError(f"{what}: q, k and the weights must be contiguous "
                         "in head_dim")
    qo = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    ko = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    LL = ctypes.c_longlong * 3
    tabs = [None, None]
    sc = (ctypes.c_longlong * 4)(0, 0, 0, 0)
    if rope:
        tabs = [t.expand(B, T, D) for t in (cos, sin)]
        for t in tabs:
            if t.device != q.device or t.dtype != torch.float32 \
                    or t.stride(2) != 1:
                raise ValueError(f"{what}: cos / sin must be fp32 (B, T, D) "
                                 "tables on q's device, contiguous in D")
        sc = (ctypes.c_longlong * 4)(tabs[0].stride(0), tabs[0].stride(1),
                                     tabs[1].stride(0), tabs[1].stride(1))
    rc = fa.build_kernels()["fused_norm"].moss_qk_norm_rope(
        code, B, T, H, k.shape[2], D, eps, int(rope), q.data_ptr(),
        LL(*q.stride()[:3]), k.data_ptr(), LL(*k.stride()[:3]),
        w_q.data_ptr(), w_k.data_ptr(),
        *(None if t is None else t.data_ptr() for t in tabs), sc,
        qo.data_ptr(), ko.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    fa._check_rc(rc, what)
    fa._count(qk_norm_rope)
    return qo, ko


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in one launch: gate and up of one shape and type,
    contiguous, 16-byte aligned. CPU tensors take ``silu_mul_plain``."""
    if not gate.is_cuda:
        return silu_mul_plain(gate, up)
    what = "silu_mul"
    code = _dtype_code(what, gate)
    _same(what, gate, up=up)
    if up.shape != gate.shape:
        raise ValueError(f"{what}: up {tuple(up.shape)} for gate "
                         f"{tuple(gate.shape)}")
    if not (gate.is_contiguous() and up.is_contiguous()) \
            or gate.data_ptr() % 16 or up.data_ptr() % 16:
        raise ValueError(f"{what}: gate and up must be contiguous and "
                         "16-byte aligned")
    out = torch.empty_like(gate, memory_format=torch.contiguous_format)
    rc = fa.build_kernels()["fused_norm"].moss_silu_mul(
        code, out.numel(), gate.data_ptr(), up.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(gate.device).cuda_stream)
    fa._check_rc(rc, what)
    fa._count(silu_mul)
    return out


for _fn in (residual_rms_norm, qk_norm_rope, silu_mul):
    fa.count_launches(_fn)
