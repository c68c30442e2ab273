"""Flash attention for the LM: Hopper kernels plus their plain versions.

Ports the three TPU kernels of ``moss_ttsd_tpu/ops/pallas_attention.py``:

  * ``flash_prefill``        — causal GQA prefill attention
                               (CUDA: ``csrc/flash_prefill.cu``: wgmma
                               tensor-core tiles for bf16, a SIMT kernel
                               for fp32 — chosen by dtype);
  * ``flash_decode_hs``      — single-query GQA decode over the head-major
                               cache, extent-clamped, split-K over the
                               cache (CUDA: ``csrc/flash_decode.cu``, chunks
                               from ``decode_split_plan``);
  * ``flash_decode_int8_hs`` — the same decode over an int8 cache with fp32
                               per-head-per-token scales, split-K as well
                               (CUDA: ``csrc/flash_decode_int8.cu``; both
                               decodes are ``csrc/decode_split.cuh``'s
                               kernel over their cache type).

``flash_prefill`` and ``flash_decode_hs`` take a ``window`` W (the AFMoE
block's sliding layers; the TPU kernels have none): a query at position i
sees the keys j with i - W < j <= i, and a decode row the slots [extent -
W, extent). 0 keeps every earlier key, the kernels' instantiations of
before. The same build holds ``csrc/moe_experts.cu``, the AFMoE block's
grouped expert product (``ops/moe.py``), ``csrc/w8a16.cu``, the int8
weights' products (``ops/w8a16.py``), and ``csrc/fused_norm.cu``, the
decoder blocks' fused norms (``ops/fused_norm.py``).

A CUDA tensor always goes to the kernel (or the wrapper raises); a CPU
tensor goes to the plain PyTorch version beside it, which is also the
kernel's oracle on the card. Both compute the softmax in fp32, round the
probabilities to q's type before P.V as the TPU kernels do (bf16; the
plain versions take it as ``p_dtype``), and give 0 for a query row with no
valid key (the TPU kernels' finite ``NEG_INF`` / ``max(l, 1e-30)`` contract
keeps such rows finite; the port pins their value to 0 so kernel and plain
version agree on every row).

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use into
shared libraries with a plain C interface (loaded with ``ctypes``), cached
under ``build/moss_ttsd_torch/<hash of the sources>/`` in the checkout, or
under another root that ``set_build_root`` names before the first build
(the server's ``--jax_cache_dir``).
Each wrapper counts its launches in ``<wrapper>.launches``; a CUDA graph's
warm-up and capture record theirs apart (``recording_launches``), and each
replay adds what its capture recorded (``add_launch_counts``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import torch

from ..utils.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "moss_ttsd_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"flash_prefill": "flash_prefill.cu",
           "flash_decode": "flash_decode.cu",
           "flash_decode_int8": "flash_decode_int8.cu",
           "moe_experts": "moe_experts.cu",
           "w8a16": "w8a16.cu",
           "fused_norm": "fused_norm.cu"}
HEAD_DIMS = (16, 32, 64, 128)
PREFILL_BF16_HEAD_DIMS = (64, 128)   # the wgmma kernel's 128-byte panels
DECODE_TILE = 64                     # flash_decode.cu key slots per tile
DECODE_MAX_SPLIT = 32                # most partials a split decode merges
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_L_FLOOR = 1e-30

_build_root = BUILD_ROOT
_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
build_info: Dict[str, object] = {}
_sm_counts: Dict[int, int] = {}
_split_counters: Dict[Tuple[int, int], torch.Tensor] = {}


# ---------------------------------------------------------------------------
# Build + bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def set_build_root(path: Optional[str]) -> Path:
    """The directory the kernel libraries are built into and loaded from,
    as ``<path>/<hash of the sources>/``: a restart reuses what an earlier
    process built there. None is the default ``BUILD_ROOT``; "" a fresh
    temporary directory (nothing reused). It must be set before the first
    kernel is built: a process whose kernels are loaded from another root
    raises. Returns the root."""
    global _build_root
    root = (BUILD_ROOT if path is None else
            Path(tempfile.mkdtemp(prefix="moss_ttsd_kernels_")) if path == ""
            else Path(path).resolve())
    with _build_lock:
        if _libs and root != _build_root:
            raise RuntimeError(f"the kernels are already loaded from "
                               f"{_build_root}; set the build root before "
                               f"the first kernel is built")
        _build_root = root
    return root


def build_root() -> Path:
    """The current build root (``set_build_root``)."""
    return _build_root


def build_kernels() -> Dict[str, ctypes.CDLL]:
    """Compile (once per source hash) and load every kernel library.

    One ``nvcc`` per source, all started together. Returns the loaded
    libraries; ``build_info`` records the build seconds and ptxas report,
    and the ``setup.kernels`` span the build or load, with ``compiled``
    the number of sources nvcc built."""
    with _build_lock:
        if len(_libs) == len(SOURCES):
            return _libs
        with span("setup.kernels") as sp:
            _build_and_load()
            sp.set(compiled=len(build_info["compiled"]))
        return _libs


def _build_and_load() -> None:
    """``build_kernels`` under its lock, the libraries not yet loaded."""
    t0 = time.perf_counter()
    out_dir = _build_root / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    procs = {}
    for name, so in todo.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so)
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, so)          # atomic: concurrent processes agree
        (out_dir / f"{name}.ptxas.log").write_text(log)
    for name, so in todo.items():
        lib = ctypes.CDLL(str(so))
        _bind(name, lib)
        _libs[name] = lib
    build_info.update(seconds=time.perf_counter() - t0,
                      compiled=sorted(procs), dir=str(out_dir),
                      ptxas={n: (out_dir / f"{n}.ptxas.log").read_text()
                             for n in SOURCES
                             if (out_dir / f"{n}.ptxas.log").exists()})


def _bind(name: str, lib: ctypes.CDLL) -> None:
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    if name == "flash_prefill":
        fn = lib.moss_flash_prefill
        fn.argtypes = [I, P, P, P, P, P, I, I, I, I, I, F] + [LL] * 13 + [I, P]
        lib.moss_flash_prefill_kernel_launches.argtypes = [I]
        lib.moss_flash_prefill_kernel_launches.restype = LL
    elif name == "flash_decode":
        fn = lib.moss_flash_decode
        fn.argtypes = ([I, P, P, P, P, P, I, P, I, I, I, I, I, F, I, I, P, P, P]
                       + [LL] * 11 + [I, P])
    elif name == "moe_experts":
        fn = lib.moss_moe_experts
        fn.argtypes = [I] + [P] * 10 + [I] * 5 + [LL] * 3 + [P]
        grouped = lib.moss_moe_experts_grouped
        grouped.argtypes = [I] + [P] * 12 + [I] * 5 + [LL] * 3 + [P]
        grouped.restype = I
    elif name == "w8a16":
        fn = lib.moss_w8a16
        fn.argtypes = [I, I, I, P, LL] + [P] * 7 + [I, I, P]
    elif name == "fused_norm":
        lib.moss_residual_rms_norm.argtypes = ([I, I, I, F] + [P, LL] * 2
                                               + [P, P] + [P, LL] * 2 + [P])
        lib.moss_qk_norm_rope.argtypes = [I] * 6 + [F, I] + [P] * 12
        lib.moss_residual_rms_norm.restype = I
        lib.moss_qk_norm_rope.restype = I
        fn = lib.moss_silu_mul
        fn.argtypes = [I, LL, P, P, P, P]
    else:
        fn = lib.moss_flash_decode_int8
        fn.argtypes = ([I, P, P, P, P, P, P, P, I, P, I, I, I, I, I, F, I, I,
                        P, P, P] + [LL] * 15 + [P])
    fn.restype = I


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _check_common(q, tensors, key_valid, what):
    dev = q.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be contiguous in head_dim")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {q.dtype} not supported "
                         "(float32, bfloat16)")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    if key_valid.device != dev or key_valid.dtype != torch.bool:
        raise ValueError(f"{what}: key_valid must be a bool tensor on {dev}")
    if key_valid.stride(-1) != 1:
        raise ValueError(f"{what}: key_valid must be contiguous in its last dim")


def _check_rows_16b(t: torch.Tensor, what: str, name: str) -> None:
    """16-byte vector loads of t's rows (cp.async): base and outer strides
    16-byte aligned."""
    esz = t.element_size()
    if t.data_ptr() % 16 or any((t.stride(i) * esz) % 16
                                for i in range(t.dim() - 1)):
        raise ValueError(f"{what}: {name} rows must be 16-byte aligned")


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: torch.Tensor, scale: float,
                        out_dtype: Optional[torch.dtype] = None,
                        p_dtype: Optional[torch.dtype] = None,
                        window: int = 0) -> torch.Tensor:
    """Plain version of ``flash_prefill``: dense causal masked softmax in
    fp32 from the same inputs. ``out_dtype`` defaults to q.dtype (fp32 keeps
    the unrounded oracle). ``p_dtype`` rounds the probabilities to that
    dtype before the P.V product (the denominator sums them in fp32), as
    the bf16 kernel and the TPU kernel's ``p.astype(v.dtype)`` do.
    ``window`` > 0: query i sees keys j > i - window only."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    pos = torch.arange(T, device=q.device)
    causal = pos[None, :] <= pos[:, None]
    if window:
        causal = causal & (pos[None, :] > pos[:, None] - window)
    mask = causal[None] & key_valid[:, None, :]
    mask = mask[:, None, None]                              # (B,1,1,T,T)
    out = _masked_softmax_pv(s, mask, v.float(), "bhgts,bshd->bthgd",
                             p_dtype)
    return out.reshape(B, T, H, D).to(out_dtype or q.dtype)


def _masked_softmax_pv(s, mask, v, pv_eq, p_dtype=None):
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)   # finite when empty
    p = torch.exp(s - m)                                    # masked -> 0
    l = p.sum(dim=-1, keepdim=True).clamp_min(_L_FLOOR)
    return torch.einsum(pv_eq, _p_for_pv(p, None, p_dtype) / l, v)


def _p_for_pv(p, vscale, p_dtype):
    """The probabilities that P.V reads: p times an int8 cache's v scales
    where given, then rounded to ``p_dtype`` (None keeps fp32), as the
    kernels and the TPU kernels round them (``p.astype(v.dtype)``,
    ``(p * vs).astype(q.dtype)``); the denominator sums p unrounded."""
    if vscale is not None:
        p = p * vscale
    return p if p_dtype is None else p.to(p_dtype).float()


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_valid: torch.Tensor, scale: float,
                  window: int = 0) -> torch.Tensor:
    """Causal GQA prefill attention.

    q (B, T, H, D); k/v (B, T, Hkv, D) (prefill writes cache slots [0, T));
    key_valid (B, T) bool; ``window`` > 0: query i sees keys j > i - window
    only. Returns (B, T, H, D) in q.dtype. On the card,
    bf16 runs the wgmma tensor-core kernel (head_dim 64 or 128, rows 16-byte
    aligned) and fp32 the SIMT kernel (head_dim in ``HEAD_DIMS``); any other
    bf16 shape raises."""
    if window < 0:
        raise ValueError(f"flash_prefill: window {window} < 0")
    if q.device.type != "cuda":
        return flash_prefill_plain(q, k, v, key_valid, scale,
                                   p_dtype=q.dtype, window=window)
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_prefill: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if key_valid.shape != (B, T):
        raise ValueError(f"flash_prefill: key_valid {tuple(key_valid.shape)}"
                         f" != {(B, T)}")
    _check_common(q, {"k": k, "v": v}, key_valid, "flash_prefill")
    if q.dtype == torch.bfloat16:
        if D not in PREFILL_BF16_HEAD_DIMS:
            raise ValueError(f"flash_prefill: bf16 head_dim {D} not in "
                             f"{PREFILL_BF16_HEAD_DIMS} (the tensor-core "
                             "kernel's tiles)")
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_rows_16b(t, "flash_prefill", name)
    lib = build_kernels()["flash_prefill"]
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.moss_flash_prefill(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_valid.data_ptr(), out.data_ptr(), B, T, H, H // Hkv, D,
        float(scale), q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), key_valid.stride(0),
        out.stride(0), out.stride(1), out.stride(2), int(window), stream)
    _check_rc(rc, "flash_prefill")
    _count(flash_prefill)
    return out


flash_prefill.launches = 0


def prefill_kernel_launches() -> Dict[str, int]:
    """Launches of each prefill kernel so far, as the library counts them
    where it launches each: {"simt": fp32 kernel, "wgmma": bf16 kernel}.
    The dispatch check of ``chip_smoke.py`` reads them."""
    fn = build_kernels()["flash_prefill"].moss_flash_prefill_kernel_launches
    return {"simt": fn(0), "wgmma": fn(1)}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _extent_mask(extent, B: int, S: int, device,
                 window: int = 0) -> Optional[torch.Tensor]:
    """(B, S) slots below each row's extent (and, with a window, at or past
    extent - window), or None: every slot."""
    if extent is None:
        if not window:
            return None
        extent = S
    pos = torch.arange(S, device=device)
    if isinstance(extent, torch.Tensor):
        ext = extent.to(device=device, dtype=torch.int64).reshape(-1)
        ext = ext.expand(B)[:, None]
    else:
        ext = torch.full((B, 1), int(extent), device=device)
    mask = pos[None, :] < ext
    if window:
        mask = mask & (pos[None, :] >= ext - window)
    return mask


def _extent_arg(extent, B: int, device, S: int, what: str):
    """(pointer or None, scalar) kernel arguments of a decode extent."""
    if isinstance(extent, torch.Tensor):
        if (extent.device != device or extent.dtype != torch.int32
                or extent.shape != (B,) or extent.stride(0) != 1):
            raise ValueError(f"{what}: a tensor extent must be a "
                             f"contiguous ({B},) int32 tensor on {device}")
        return extent.data_ptr(), S
    return None, S if extent is None else int(extent)


def decode_split_plan(B: int, Hkv: int, S: int, sm_count: int
                      ) -> Tuple[int, int]:
    """(n_split, chunk) of the split-K decode over a cache of capacity S.

    A pure function of the shapes: the extent never enters, so a tensor
    extent or a captured step needs no host read. ``chunk`` is a multiple
    of the 64-slot tile and n_split * chunk >= S. It splits only when
    B * Hkv < sm_count, and then cuts chunks of as few tiles as keep the
    merge at most ``DECODE_MAX_SPLIT`` partials: a block's tiles are a
    chain of dependent loads, so one tile a chunk is the fastest plan on
    the H100 until the merge of many partials costs more (PERF.md §6).
    B * Hkv * n_split reaches ``sm_count`` wherever the cache has enough
    tiles for it."""
    tiles = max(1, -(-S // DECODE_TILE))
    if B * Hkv >= sm_count:
        return 1, tiles * DECODE_TILE
    want = -(-sm_count // (B * Hkv))            # chunks per (row, kv-head)
    per = min(max(1, tiles // want),            # tiles per chunk
              -(-tiles // DECODE_MAX_SPLIT))
    return -(-tiles // per), per * DECODE_TILE


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once, cached)."""
    idx = _device_index(device)
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _arrival_counters(device: torch.device, stream: int) -> torch.Tensor:
    """The split-K merge's per-(row, kv-head) ticket counters of one CUDA
    stream: zeroed once when created, re-armed by each launch's merging
    block, and never replaced, so a CUDA graph may keep their address.
    Launches on two streams never share a ticket. A graph keeps the
    counters of the stream it was captured on: two graphs captured on one
    stream must not replay at the same time. ``sm_count`` counters serve
    every plan that splits (``decode_split_plan`` splits only below
    ``sm_count`` rows x kv-heads)."""
    key = (_device_index(device), stream)
    c = _split_counters.get(key)
    if c is None:
        c = torch.zeros(sm_count(device), dtype=torch.int32, device=device)
        _split_counters[key] = c
    return c


class _SplitLaunch:
    """The split-K arguments of one decode launch: the plan ``split`` =
    (n_split, chunk), or ``decode_split_plan``'s, checked; for n_split > 1
    the fp32 partials' workspace (held here until the launch is queued) and
    the stream's ticket counters. ``args`` = (chunk, n_split, ws_acc,
    ws_ml, counters), null pointers unsplit."""

    def __init__(self, device, stream, B, Hkv, S, G, D, split, what):
        n_split, chunk = split or decode_split_plan(B, Hkv, S,
                                                    sm_count(device))
        if (chunk <= 0 or chunk % DECODE_TILE or n_split < 1
                or n_split * chunk < S):
            raise ValueError(f"{what}: split {(n_split, chunk)} does not "
                             f"cover {S} slots in chunks of 64-slot tiles")
        self.ws = None
        self.args = (chunk, n_split, None, None, None)
        if n_split > 1:
            parts = B * Hkv * n_split * G
            self.ws = torch.empty(parts * (D + 2), dtype=torch.float32,
                                  device=device)
            c = _arrival_counters(device, stream)
            if B * Hkv > c.numel():
                raise ValueError(f"{what}: a split over {B} x {Hkv} rows x "
                                 f"kv-heads needs more than the {c.numel()} "
                                 "ticket counters (one per SM)")
            self.args = (chunk, n_split, self.ws.data_ptr(),
                         self.ws[parts * D:].data_ptr(), c.data_ptr())


def _decode_scores(q, k, key_valid, scale, extent, ks=None, window=0):
    """(B, Hkv, G, S) fp32 scores of a single-query decode as the kernels
    form them, (q . k) * scale, or over an int8 cache (q . kq) *
    (ks * scale); -inf at the slots that are not valid, lie at or past
    the extent, or (a window) before extent - window."""
    B, _, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q[:, 0].float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    s = s * scale if ks is None else s * (ks.float() * scale)[:, :, None, :]
    mask = key_valid
    ext = _extent_mask(extent, B, S, q.device, window)
    if ext is not None:
        mask = mask & ext
    return s.masked_fill(~mask[:, None, None, :], float("-inf"))


def _softmax_sums(s, v, vscale, p_dtype):
    """Max m, denominator l = sum e^(s - m) and unnormalised sum acc =
    sum_s p_s v_s (P as ``_p_for_pv`` makes it) of masked decode scores s
    (B, Hkv, G, S') over v (B, Hkv, S', D); m = NEG_INF, l = 0 when no
    score is valid."""
    m = s.amax(dim=-1).clamp_min(_NEG_INF)          # finite when empty
    p = torch.exp(s - m[..., None])                 # masked -> 0
    acc = torch.einsum("bhgs,bhsd->bhgd", _p_for_pv(p, vscale, p_dtype),
                       v.float())
    return m, p.sum(dim=-1), acc


def _decode_dense(q, k, v, ks, vs, key_valid, scale, extent, p_dtype,
                  out_dtype, window=0):
    s = _decode_scores(q, k, key_valid, scale, extent, ks, window)
    vscale = None if vs is None else vs.float()[:, :, None, :]
    _, l, acc = _softmax_sums(s, v, vscale, p_dtype)
    out = acc / l.clamp_min(_L_FLOOR)[..., None]
    return out.reshape(q.shape).to(out_dtype or q.dtype)


def _decode_split(q, k, v, ks, vs, key_valid, scale, extent, n_split, chunk,
                  p_dtype, out_dtype, window=0):
    """The split-K kernel's arithmetic (see flash_decode_hs_split_plain),
    over a cache of q's type (ks = vs = None) or an int8 one."""
    S = k.shape[2]
    if chunk is None:
        tiles = -(-S // DECODE_TILE)
        chunk = -(-tiles // n_split) * DECODE_TILE
    s = _decode_scores(q, k, key_valid, scale, extent, ks, window)
    vscale = None if vs is None else vs.float()[:, :, None, :]
    ms, ls, accs = [], [], []
    # a chunk past the capacity is empty: weight 0 in the merge, left out
    for c0 in range(0, min(n_split * chunk, S), chunk):
        sl = slice(c0, c0 + chunk)
        m, l, acc = _softmax_sums(s[..., sl], v[:, :, sl],
                                  None if vscale is None else vscale[..., sl],
                                  p_dtype)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m_s, l_s, acc_s = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    live = l_s > 0
    m = torch.where(live, m_s, _NEG_INF).amax(dim=0)
    w = torch.where(live, torch.exp(m_s - m), 0.0)
    l = (w * l_s).sum(dim=0).clamp_min(_L_FLOOR)
    out = (w[..., None] * acc_s).sum(dim=0) / l[..., None]
    return out.reshape(q.shape).to(out_dtype or q.dtype)


def flash_decode_hs_plain(q: torch.Tensor, kt: torch.Tensor,
                          vt: torch.Tensor, key_valid: torch.Tensor,
                          scale: float, extent=None, layer=None,
                          out_dtype: Optional[torch.dtype] = None,
                          p_dtype: Optional[torch.dtype] = None,
                          window: int = 0) -> torch.Tensor:
    """Plain version of ``flash_decode_hs``: dense masked softmax in fp32
    over the slots below the extent (at or past extent - ``window`` when
    one is given). ``p_dtype`` rounds the probabilities
    to that dtype before the P.V product (the denominator sums them in
    fp32), as the bf16 kernel and the TPU kernel's ``p.astype(v.dtype)``
    do; None keeps them fp32."""
    if layer is not None:
        kt, vt = kt[int(layer)], vt[int(layer)]
    return _decode_dense(q, kt, vt, None, None, key_valid, scale, extent,
                         p_dtype, out_dtype, window)


def flash_decode_hs_split_plain(q: torch.Tensor, kt: torch.Tensor,
                                vt: torch.Tensor, key_valid: torch.Tensor,
                                scale: float, extent=None, layer=None,
                                n_split: int = 1,
                                chunk: Optional[int] = None,
                                out_dtype: Optional[torch.dtype] = None,
                                p_dtype: Optional[torch.dtype] = None,
                                window: int = 0) -> torch.Tensor:
    """The split-K arithmetic of the ``flash_decode_hs`` kernel in plain
    torch (for the tests and the card's checks), over the slots of
    ``flash_decode_hs_plain``: per chunk of ``chunk``
    slots (default: the 64-slot tiles dealt evenly over ``n_split``) the
    running max m, denominator l and unnormalised sum acc (P rounded to
    ``p_dtype`` as in ``flash_decode_hs_plain``, against the chunk's max),
    an empty chunk (m = NEG_INF, l = 0) past the extent or with no valid
    key; then the kernel's merge, out = sum e^(m_s - m) acc_s /
    max(sum e^(m_s - m) l_s, 1e-30) with m the max over non-empty
    chunks."""
    if layer is not None:
        kt, vt = kt[int(layer)], vt[int(layer)]
    return _decode_split(q, kt, vt, None, None, key_valid, scale, extent,
                         n_split, chunk, p_dtype, out_dtype, window)


def flash_decode_hs(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                    key_valid: torch.Tensor, scale: float,
                    extent: Union[None, int, torch.Tensor] = None,
                    layer: Optional[int] = None,
                    split: Optional[Tuple[int, int]] = None,
                    window: int = 0) -> torch.Tensor:
    """Single-query GQA decode attention over the head-major cache.

    q (B, 1, H, D); kt/vt (B, Hkv, S, D), or the full (L, B, Hkv, S, D)
    stack with ``layer`` (``kt[layer]`` is a free view in torch: the port
    never copies a layer's cache to call the kernel); key_valid (B, S) bool.
    ``extent``: None (all S slots), an int, or a (B,) int32 tensor — slots at
    or past a row's extent are never read, and must be key_valid=False.
    Returns (B, 1, H, D) in q.dtype. On the card the kernel is split-K over
    the cache into ``split`` = (n_split, chunk), by default
    ``decode_split_plan``'s; the fp32 partials go to a workspace allocated
    here, and the last block of each (row, kv-head) merges them in the same
    launch. On the CPU a given ``split`` runs the plain split arithmetic.
    P is rounded to q's type before P.V, on the card and on the CPU.
    ``window`` > 0: each row reads only the slots [extent - window,
    extent)."""
    if window < 0:
        raise ValueError(f"flash_decode_hs: window {window} < 0")
    if layer is not None:
        kt, vt = kt[int(layer)], vt[int(layer)]
    if q.device.type != "cuda":
        if split is not None:
            return flash_decode_hs_split_plain(
                q, kt, vt, key_valid, scale, extent, n_split=split[0],
                chunk=split[1], p_dtype=q.dtype, window=window)
        return flash_decode_hs_plain(q, kt, vt, key_valid, scale, extent,
                                     p_dtype=q.dtype, window=window)
    B, one, H, D = q.shape
    Hkv, S = kt.shape[1], kt.shape[2]
    if (one != 1 or kt.shape != (B, Hkv, S, D) or vt.shape != kt.shape
            or H % Hkv):
        raise ValueError(f"flash_decode_hs: shapes q {tuple(q.shape)}, "
                         f"kt {tuple(kt.shape)}, vt {tuple(vt.shape)}")
    if key_valid.shape != (B, S):
        raise ValueError(f"flash_decode_hs: key_valid "
                         f"{tuple(key_valid.shape)} != {(B, S)}")
    _check_common(q, {"kt": kt, "vt": vt}, key_valid, "flash_decode_hs")
    for name, t in (("kt", kt), ("vt", vt)):
        _check_rows_16b(t, "flash_decode_hs", name)
    ext_ptr, ext_scalar = _extent_arg(extent, B, q.device, S,
                                      "flash_decode_hs")
    G = H // Hkv
    lib = build_kernels()["flash_decode"]
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sp = _SplitLaunch(q.device, stream, B, Hkv, S, G, D, split,
                      "flash_decode_hs")
    rc = lib.moss_flash_decode(
        _DTYPE_CODE[q.dtype], q.data_ptr(), kt.data_ptr(), vt.data_ptr(),
        key_valid.data_ptr(), ext_ptr, ext_scalar, out.data_ptr(),
        B, Hkv, G, S, D, float(scale), *sp.args, q.stride(0), q.stride(2),
        kt.stride(0), kt.stride(1), kt.stride(2),
        vt.stride(0), vt.stride(1), vt.stride(2), key_valid.stride(0),
        out.stride(0), out.stride(2), int(window), stream)
    _check_rc(rc, "flash_decode_hs")
    _count(flash_decode_hs)
    return out


flash_decode_hs.launches = 0


def flash_decode_int8_hs_plain(q: torch.Tensor, kq: torch.Tensor,
                               ks: torch.Tensor, vq: torch.Tensor,
                               vs: torch.Tensor, key_valid: torch.Tensor,
                               scale: float, extent=None, layer=None,
                               out_dtype: Optional[torch.dtype] = None,
                               p_dtype: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """Plain version of ``flash_decode_int8_hs``: the dense masked softmax
    of ``flash_decode_hs_plain`` in fp32 with the scales folded around the
    two products as the kernel folds them: scores (q . kq) * (ks * scale),
    then P.V over the int8 rows with p * vs, rounded to ``p_dtype`` when
    given (the TPU kernel's ``(p * vs).astype(q.dtype)``)."""
    if layer is not None:
        kq, ks, vq, vs = (t[int(layer)] for t in (kq, ks, vq, vs))
    return _decode_dense(q, kq, vq, ks, vs, key_valid, scale, extent,
                         p_dtype, out_dtype)


def flash_decode_int8_hs_split_plain(q: torch.Tensor, kq: torch.Tensor,
                                     ks: torch.Tensor, vq: torch.Tensor,
                                     vs: torch.Tensor,
                                     key_valid: torch.Tensor, scale: float,
                                     extent=None, layer=None,
                                     n_split: int = 1,
                                     chunk: Optional[int] = None,
                                     out_dtype: Optional[torch.dtype] = None,
                                     p_dtype: Optional[torch.dtype] = None
                                     ) -> torch.Tensor:
    """The split-K arithmetic of the ``flash_decode_int8_hs`` kernel in
    plain torch: ``flash_decode_hs_split_plain``'s chunks and merge, with
    the scores and P.V of ``flash_decode_int8_hs_plain``."""
    if layer is not None:
        kq, ks, vq, vs = (t[int(layer)] for t in (kq, ks, vq, vs))
    return _decode_split(q, kq, vq, ks, vs, key_valid, scale, extent,
                         n_split, chunk, p_dtype, out_dtype)


def flash_decode_int8_hs(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                         vq: torch.Tensor, vs: torch.Tensor,
                         key_valid: torch.Tensor, scale: float,
                         extent: Union[None, int, torch.Tensor] = None,
                         layer: Optional[int] = None,
                         split: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
    """Single-query GQA decode attention over an int8 KV cache.

    q (B, 1, H, D) fp32/bf16; kq/vq (B, Hkv, S, D) int8 and ks/vs
    (B, Hkv, S) fp32 per-head-per-token scales (k ~ kq * ks[..., None]), or
    the full (L, ...) stacks with ``layer`` (free views, never copied);
    key_valid (B, S) bool; ``extent`` as in ``flash_decode_hs``. The k scale
    multiplies the score column and the v scale the probability row (p * vs
    rounded to q's type before P.V), so the kernel reads the int8 rows as
    they are. Returns (B, 1, H, D) in q.dtype. On the card the kernel is
    split-K over the cache as ``flash_decode_hs``'s (``split``, by default
    ``decode_split_plan``'s); on the CPU a given ``split`` runs the plain
    split arithmetic."""
    if layer is not None:
        kq, ks, vq, vs = (t[int(layer)] for t in (kq, ks, vq, vs))
    if q.device.type != "cuda":
        if split is not None:
            return flash_decode_int8_hs_split_plain(
                q, kq, ks, vq, vs, key_valid, scale, extent,
                n_split=split[0], chunk=split[1], p_dtype=q.dtype)
        return flash_decode_int8_hs_plain(q, kq, ks, vq, vs, key_valid, scale,
                                          extent, p_dtype=q.dtype)
    what = "flash_decode_int8_hs"
    B, one, H, D = q.shape
    Hkv, S = kq.shape[1], kq.shape[2]
    if (one != 1 or kq.shape != (B, Hkv, S, D) or vq.shape != kq.shape
            or ks.shape != (B, Hkv, S) or vs.shape != ks.shape or H % Hkv):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, kq "
                         f"{tuple(kq.shape)}, ks {tuple(ks.shape)}, vq "
                         f"{tuple(vq.shape)}, vs {tuple(vs.shape)}")
    if key_valid.shape != (B, S):
        raise ValueError(f"{what}: key_valid {tuple(key_valid.shape)} != "
                         f"{(B, S)}")
    _check_common(q, {}, key_valid, what)
    for name, t, dt in (("kq", kq, torch.int8), ("vq", vq, torch.int8),
                        ("ks", ks, torch.float32), ("vs", vs, torch.float32)):
        if t.device != q.device or t.dtype != dt or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be {dt} on {q.device}, "
                             "contiguous in its last dim")
    for name, t in (("kq", kq), ("vq", vq)):
        _check_rows_16b(t, what, name)
    ext_ptr, ext_scalar = _extent_arg(extent, B, q.device, S, what)
    G = H // Hkv
    lib = build_kernels()["flash_decode_int8"]
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sp = _SplitLaunch(q.device, stream, B, Hkv, S, G, D, split, what)
    rc = lib.moss_flash_decode_int8(
        _DTYPE_CODE[q.dtype], q.data_ptr(), kq.data_ptr(), ks.data_ptr(),
        vq.data_ptr(), vs.data_ptr(), key_valid.data_ptr(), ext_ptr,
        ext_scalar, out.data_ptr(), B, Hkv, G, S, D, float(scale), *sp.args,
        q.stride(0), q.stride(2), kq.stride(0), kq.stride(1), kq.stride(2),
        ks.stride(0), ks.stride(1), vq.stride(0), vq.stride(1), vq.stride(2),
        vs.stride(0), vs.stride(1), key_valid.stride(0), out.stride(0),
        out.stride(2), stream)
    _check_rc(rc, what)
    _count(flash_decode_int8_hs)
    return out


flash_decode_int8_hs.launches = 0

_WRAPPERS = (flash_prefill, flash_decode_hs, flash_decode_int8_hs)
# every counted wrapper: the attention ones and those of other modules whose
# kernels are built here (count_launches)
_COUNTED = list(_WRAPPERS)


def count_launches(fn) -> None:
    """Count the wrapper ``fn``'s launches as this module counts its own
    (``fn.launches``, recorded in a capture and added by each replay): a
    kernel of another module built here (``ops/moe.moe_experts``).
    ``launch_counts`` stays the attention wrappers'."""
    fn.launches = 0
    if fn not in _COUNTED:
        _COUNTED.append(fn)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """The attention wrappers' launches."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by wrapper name) to the wrappers' counters: a CUDA
    graph's replay adds the calls it captured."""
    for fn in _COUNTED:
        fn.launches += counts.get(fn.__name__, 0)


_recording = threading.local()


def _count(fn) -> None:
    """One call of the wrapper ``fn``: into this thread's open recording
    (``recording_launches``), else into ``fn.launches``."""
    calls = getattr(_recording, "calls", None)
    if calls is None:
        fn.launches += 1
    else:
        calls[fn.__name__] = calls.get(fn.__name__, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """The wrapper calls this thread makes inside the block, by name, kept
    out of the counters (a CUDA graph's warm-up and capture: its replays
    add what the capture recorded). Other threads count as before."""
    prev = getattr(_recording, "calls", None)
    _recording.calls = calls = {}
    try:
        yield calls
    finally:
        _recording.calls = prev
