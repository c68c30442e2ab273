"""The weight-only int8 product (w8a16) of ``QLinear`` and the tied int8
heads: y = x (W_q s)^T for activations x (..., K), an int8 weight W_q
(N, K) and fp32 per-output-row scales s.

  * ``w8a16_plain``: the product as the port computed it before the
    kernels, and still does on the CPU: the weight dequantized into a copy
    in x's type, then one matrix product. A projection (``head`` False)
    multiplies ``q.to(x.dtype) * s.to(x.dtype)`` and runs ``F.linear``; a
    head (``head`` True) runs ``matmul_f32_out`` over ``q.to(x.dtype)`` and
    multiplies the fp32 logits by s. It is the kernels' oracle.
  * The Hopper kernels (``csrc/w8a16.cu``), one launch over up to
    ``MAX_GROUP`` weights that read the same x (q/k/v, gate/up), each weight
    byte read once and widened on the card, no copy of the weight written:
    ``w8a16_group`` for at most ``KERNEL_ROWS`` rows of bf16 (a decode
    step, the pool's step; widened in registers), ``w8a16_gemm`` for more
    rows of bf16 (a prefill, the pool's admission bursts; widened into
    shared memory on the way to the tensor cores), ``w8a16_simt`` for fp32
    x (any rows). Each equals the plain version up to the order of the
    fp32 sum (a bf16 projection's weight is rounded to bf16(bf16(q)
    bf16(s)) as the copy is). CUDA tensors only: each launches or raises.
  * ``w8a16_product`` / ``w8a16_products`` (one x, several weights): the
    choice, by what the input shows: the CPU takes the plain version; on
    the card bf16 x takes ``w8a16_group`` up to ``KERNEL_ROWS`` rows and
    ``w8a16_gemm`` above, fp32 x ``w8a16_simt``, and any other type
    raises.

Each kernel counts its launches in ``<wrapper>.launches``
(``flash_attention``'s counters: a CUDA graph's capture records them, each
replay adds them).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import flash_attention as fa

KERNEL_ROWS = 16        # the decode kernel's most rows (csrc MAX_M)
MAX_GROUP = 3           # weights of one launch (csrc MAX_GROUP)


def matmul_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation AND fp32 output.

    On the card a bf16 product goes through ``torch.mm(..., out_dtype=
    torch.float32)`` (cuBLAS writes the fp32 accumulator, no bf16 rounding
    of the logits); fp32 operands and the CPU take a plain fp32 product."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def w8a16_plain(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                head: bool = False) -> torch.Tensor:
    """Plain version of ``w8a16`` (the CPU's path and the kernels'
    oracle). x (..., K); weight_q (N, K) int8. A projection:
    scale (N, 1) fp32, bias (N,) or None, output in x's type. A head:
    scale (N,) fp32, no bias, fp32 output; x 2-D."""
    if head:
        return matmul_f32_out(x, weight_q.to(x.dtype).t()) * scale.float()
    w = weight_q.to(x.dtype) * scale.to(x.dtype)
    return F.linear(x, w, None if bias is None else bias.to(x.dtype))


Weights = Sequence[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]]

_KERNEL = {"w8a16_group": 0, "w8a16_gemm": 1, "w8a16_simt": 2}


def _launch(fn, x: torch.Tensor, weights: Weights, head: bool,
            dtype: torch.dtype, max_rows: Optional[int]) -> List[torch.Tensor]:
    """Check what the kernel of the wrapper ``fn`` takes, launch it once
    over ``weights`` and count the launch; raise on anything else."""
    what = fn.__name__
    if not 1 <= len(weights) <= MAX_GROUP:
        raise ValueError(f"{what}: {len(weights)} weights; a launch takes "
                         f"1-{MAX_GROUP}")
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be a CUDA tensor (the CPU takes "
                         "w8a16_plain)")
    if x.dim() != 2 or x.dtype != dtype:
        raise ValueError(f"{what}: x must be a 2-D {dtype} tensor, not "
                         f"{tuple(x.shape)} {x.dtype}")
    M, K = x.shape
    if M < 1 or (max_rows is not None and M > max_rows):
        raise ValueError(f"{what}: {M} rows; the kernel takes 1-"
                         f"{max_rows} (more go to w8a16_gemm)")
    if K % 16 or K == 0:
        raise ValueError(f"{what}: K {K} must be a positive multiple of 16")
    if x.stride(1) != 1:
        raise ValueError(f"{what}: x must be contiguous in K")
    vector = dtype == torch.bfloat16          # 16-byte loads of x and W
    if vector:
        fa._check_rows_16b(x, what, "x")
    out_dtype = torch.float32 if head else dtype
    outs, cols = [], []
    for q, s, b in weights:
        if not (q.is_cuda and s.is_cuda) or q.device != x.device \
                or s.device != x.device:
            raise ValueError(f"{what}: the weights must be CUDA tensors on "
                             "x's device (the CPU takes w8a16_plain)")
        if q.dim() != 2 or q.dtype != torch.int8 or q.shape[1] != K:
            raise ValueError(f"{what}: weight_q {tuple(q.shape)} {q.dtype} "
                             f"for x {tuple(x.shape)}: an int8 (N, {K})")
        N = q.shape[0]
        s = s.reshape(-1)
        if s.dtype != torch.float32 or s.numel() != N or s.stride(0) != 1:
            raise ValueError(f"{what}: scale must hold {N} contiguous fp32 "
                             "values")
        if q.stride(1) != 1:
            raise ValueError(f"{what}: weight_q must be contiguous in K")
        if vector:
            fa._check_rows_16b(q, what, "weight_q")
        if b is not None and (head or b.dtype != dtype or b.shape != (N,)
                              or b.stride(0) != 1 or b.device != x.device):
            raise ValueError(f"{what}: bias must be a contiguous ({N},) "
                             f"{dtype} tensor on x's device, and a head "
                             "takes none")
        out = torch.empty((M, N), device=x.device, dtype=out_dtype)
        outs.append(out)
        if N:
            cols.append((q, s, b, out))
    if not cols:
        return outs
    g = len(cols)
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    lib = fa.build_kernels()["w8a16"]
    rc = lib.moss_w8a16(
        _KERNEL[what], int(head), g, x.data_ptr(), x.stride(0),
        (P * g)(*(q.data_ptr() for q, _, _, _ in cols)),
        (LL * g)(*(q.stride(0) for q, _, _, _ in cols)),
        (P * g)(*(s.data_ptr() for _, s, _, _ in cols)),
        (P * g)(*(None if b is None else b.data_ptr()
                  for _, _, b, _ in cols)),
        (P * g)(*(o.data_ptr() for _, _, _, o in cols)),
        (LL * g)(*(o.stride(0) for _, _, _, o in cols)),
        (ctypes.c_int * g)(*(q.shape[0] for q, _, _, _ in cols)), M, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    fa._check_rc(rc, what)
    fa._count(fn)
    return outs


def w8a16_group(x: torch.Tensor, weights: Weights,
                head: bool = False) -> List[torch.Tensor]:
    """The decode kernel: one launch over 1-``MAX_GROUP`` weights that read
    the same x (q/k/v, gate/up). x (M, K) bf16, 1 <= M <= ``KERNEL_ROWS``,
    rows 16-byte aligned; each (weight_q, scale, bias): weight_q (N, K)
    int8, K a multiple of 16, rows contiguous and 16-byte aligned; scale N
    fp32 values ((N,) or (N, 1)), contiguous; bias (N,) bf16 or None
    (projections only). Returns each weight's (M, N): bf16 for a
    projection, fp32 for a head. Raises on anything else, CPU tensors
    included (the CPU takes ``w8a16_plain``)."""
    return _launch(w8a16_group, x, weights, head, torch.bfloat16,
                   KERNEL_ROWS)


def w8a16_gemm(x: torch.Tensor, weights: Weights,
               head: bool = False) -> List[torch.Tensor]:
    """The many-row kernel (wgmma): ``w8a16_group``'s contract for any
    number of bf16 rows (``w8a16_products`` sends it more than
    ``KERNEL_ROWS``)."""
    return _launch(w8a16_gemm, x, weights, head, torch.bfloat16, None)


def w8a16_simt(x: torch.Tensor, weights: Weights,
               head: bool = False) -> List[torch.Tensor]:
    """The fp32 kernel: ``w8a16_group``'s contract for fp32 x (any number
    of rows, rows of any alignment), a projection's bias and output fp32."""
    return _launch(w8a16_simt, x, weights, head, torch.float32, None)


for _fn in (w8a16_group, w8a16_gemm, w8a16_simt):
    fa.count_launches(_fn)


def w8a16_product(x: torch.Tensor, weight_q: torch.Tensor,
                  scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  head: bool = False) -> torch.Tensor:
    """The w8a16 product of x (..., K) (module docstring): on the card one
    of the kernels, chosen by x's rows and type; on the CPU
    ``w8a16_plain``. A head's x is 2-D."""
    return w8a16_products(x, [(weight_q, scale, bias)], head)[0]


def w8a16_products(x: torch.Tensor, weights: Weights,
                   head: bool = False) -> List[torch.Tensor]:
    """``w8a16_product`` of one x and several (weight_q, scale, bias): on
    the card one launch for all of them, on the CPU one ``w8a16_plain``
    each. A CUDA x of another type than bf16 or fp32 raises."""
    if not x.is_cuda:
        return [w8a16_plain(x, q, s, b, head) for q, s, b in weights]
    K = x.shape[-1]
    rows = x.numel() // K if K else 0
    if x.dtype == torch.bfloat16:
        fn = w8a16_group if rows <= KERNEL_ROWS else w8a16_gemm
    elif x.dtype == torch.float32:
        fn = w8a16_simt
    else:
        raise ValueError(f"w8a16: no kernel takes {x.dtype} activations")
    lead = x.shape[:-1]
    if rows == 0:
        dt = torch.float32 if head else x.dtype
        return [x.new_empty((*lead, q.shape[0]), dtype=dt)
                for q, _, _ in weights]
    ys = fn(x.reshape(rows, K),
            [(q, s, None if b is None else b.to(x.dtype))
             for q, s, b in weights], head)
    return [y.reshape(*lead, -1) for y in ys]
