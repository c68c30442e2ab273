"""The port on a CUDA card: each Hopper kernel against its plain version,
``quantize_kv`` on the card against the CPU, and the tiny LM engine (bf16
path and int8 serving) on the card (kernels) against the same engine on the
CPU (plain versions), the tiny codec encode on the card against the CPU,
full and LoRA training steps and the tiny codec's train steps on the card
against the CPU, sequence parallelism and GPipe as two gloo processes
sharing the card against one process on the CPU. Imports no
JAX, so it runs on a machine with the card
and no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Every test carries the ``cuda`` marker and skips without a CUDA device (the
kernels have no CPU mode)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from moss_ttsd_torch.ops import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


# fp32: accumulation order only; bf16: plus one rounding of the output
TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-2, 2.0 ** -8)}


def _close(out, ref, dtype):
    atol, rel = TOL[dtype]
    assert bool(torch.isfinite(out).all())
    assert float(((out.float() - ref).abs() - rel * ref.abs()).max()) <= atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,pads", [(121, (0, 30)), (7, (3, 0)), (1, (0, 1)),
                                    (512, (54, 79))])
def test_prefill_kernel_matches_plain(cuda, dtype, T, pads):
    dt = getattr(torch, dtype)
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(dt)
    B, H, Hkv, D = 2, 16, 8, 128
    q, k, v = rn(B, T, H, D), rn(B, T, Hkv, D), rn(B, T, Hkv, D)
    valid = torch.ones(B, T, dtype=torch.bool, device="cuda")
    for b, p in enumerate(pads):
        valid[b, :p] = False
    out = fa.flash_prefill(q, k, v, valid, D ** -0.5)
    ref = fa.flash_prefill_plain(q, k, v, valid, D ** -0.5,
                                 out_dtype=torch.float32)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(dt)
    B, S, H, Hkv, D = 2, 333, 16, 8, 128
    q, kt, vt = rn(B, 1, H, D), rn(B, Hkv, S, D), rn(B, Hkv, S, D)
    valid = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    valid[0, :200] = True
    valid[1, 30:150] = True
    for ext in (200, torch.tensor([200, 150], dtype=torch.int32,
                                  device="cuda"), None):
        out = fa.flash_decode_hs(q, kt, vt, valid, D ** -0.5, extent=ext)
        ref = fa.flash_decode_hs_plain(q, kt, vt, valid, D ** -0.5,
                                       extent=ext, out_dtype=torch.float32)
        _close(out, ref, dtype)


@pytest.mark.parametrize("T,pads", [(63, (5, 0)), (64, (0, 64)),
                                    (65, (64, 1)), (128, (3, 100)),
                                    (200, (0, 199))])
@pytest.mark.parametrize("Hkv,D", [(8, 128), (4, 64)])   # G 2 and G 4
def test_prefill_tensor_core_tile_edges(cuda, T, pads, Hkv, D):
    """bf16 prefill (the wgmma kernel, 64-row tiles) at and around the tile
    edges, with left pads and a fully padded row, against the plain
    version."""
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(
        torch.bfloat16)
    B, H = 2, 16
    q, k, v = rn(B, T, H, D), rn(B, T, Hkv, D), rn(B, T, Hkv, D)
    valid = torch.ones(B, T, dtype=torch.bool, device="cuda")
    for b, p in enumerate(pads):
        valid[b, :p] = False
    out = fa.flash_prefill(q, k, v, valid, D ** -0.5)
    ref = fa.flash_prefill_plain(q, k, v, valid, D ** -0.5,
                                 out_dtype=torch.float32)
    _close(out, ref, "bfloat16")
    for b, p in enumerate(pads):
        assert bool((out[b, :p] == 0).all())


def _p_rounding_inputs(gen, B, T, H, Hkv, D):
    """bf16 q, k, v (for scale 1) on which rounding P to bf16 before P.V
    decides the output: scores are the row max (even keys) or 2^-10 below
    it (odd keys), so bf16 rounds every e^(s - m) to 1; v is +c on even
    keys and -c on odd keys, |c| in [32, 64). Odd rows are then exactly 0
    with bf16 P and ~c * 2^-11 (>= 0.0156) with fp32 P."""
    bf = torch.bfloat16
    q = torch.zeros((B, T, H, D), device="cuda")
    q[..., 0], q[..., 1] = 1.0, 2.0 ** -10
    k = torch.zeros((B, T, Hkv, D), device="cuda")
    k[..., 0] = 1.0
    k[:, 1::2, :, 1] = -1.0
    c = 32 + 32 * torch.rand((B, 1, Hkv, D), generator=gen, device="cuda")
    c = c * (2 * torch.randint(0, 2, c.shape, generator=gen, device="cuda")
             - 1)
    sign = 1 - 2 * (torch.arange(T, device="cuda") % 2)
    return q.to(bf), k.to(bf), c.to(bf) * sign[None, :, None, None].to(bf)


@pytest.mark.parametrize("T,Hkv,D", [(377, 8, 128), (130, 4, 64)])
def test_prefill_bf16_rounds_p_like_the_tpu_kernel(cuda, T, Hkv, D):
    """The wgmma kernel rounds P to bf16 before P.V (the TPU kernel's
    p.astype(v.dtype)): within 1e-3 + 2^-8 |ref| of the bf16-P plain
    version on inputs where the rounding moves odd rows by >= 0.0156,
    which the fp32-P plain version therefore misses."""
    q, k, v = _p_rounding_inputs(cuda, 2, T, 16, Hkv, D)
    valid = torch.ones(2, T, dtype=torch.bool, device="cuda")
    out = fa.flash_prefill(q, k, v, valid, 1.0).float()
    excess = {}
    for p_dtype in (torch.bfloat16, None):
        ref = fa.flash_prefill_plain(q, k, v, valid, 1.0,
                                     out_dtype=torch.float32, p_dtype=p_dtype)
        excess[p_dtype] = float(((out - ref).abs()
                                 - 2.0 ** -8 * ref.abs()).max())
    assert excess[torch.bfloat16] <= 1e-3 < excess[None]


def test_prefill_bf16_head_dims_outside_tensor_core_tiles_raise(cuda):
    q = torch.zeros(1, 3, 4, 32, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 3, 2, 32, device="cuda", dtype=torch.bfloat16)
    valid = torch.ones(1, 3, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_prefill(q, k, k, valid, 0.25)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_boundaries(cuda, dtype):
    """The split-K decode at its chunk boundaries: extents exactly at and
    one past a boundary, a long cache, a whole in-extent chunk with no valid
    key, a row with no valid key at all, a layer view — against the plain
    version and the plain split arithmetic at the kernel's plan. Batch 3 at
    capacity 761 is the voice-cloning run's decode, whose plan has chunks
    of two tiles (a tile edge inside each chunk)."""
    dt = getattr(torch, dtype)
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(dt)
    H, Hkv, D = 16, 8, 128
    for B, S in ((2, 633), (2, 4096), (3, 761)):
        n_split, chunk = fa.decode_split_plan(B, Hkv, S,
                                              fa.sm_count(torch.device("cuda")))
        assert n_split > 1 and B * Hkv * n_split >= 132
        q, kt, vt = rn(B, 1, H, D), rn(3, B, Hkv, S, D), rn(3, B, Hkv, S, D)
        for lo, hi in ((0, chunk), (0, chunk + 1), (2 * chunk + 3, S - 7),
                       (0, S), (0, 0), (0, 65)):
            valid = torch.zeros(B, S, dtype=torch.bool, device="cuda")
            valid[0, lo:hi] = True
            valid[1:, :max(hi, 1)] = True
            valid[2:, :140] = False
            ext = torch.full((B,), max(hi, 1), dtype=torch.int32,
                             device="cuda")
            out = fa.flash_decode_hs(q, kt, vt, valid, D ** -0.5, extent=ext,
                                     layer=2)
            ref = fa.flash_decode_hs_plain(q, kt, vt, valid, D ** -0.5,
                                           extent=ext, layer=2,
                                           out_dtype=torch.float32)
            split = fa.flash_decode_hs_split_plain(
                q, kt, vt, valid, D ** -0.5, extent=ext, layer=2,
                n_split=n_split, chunk=chunk, out_dtype=torch.float32)
            _close(out, ref, dtype)
            _close(out, split, dtype)
            if hi == 0:
                assert bool((out[0] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_every_split(cuda, dtype):
    """The kernel at splits other than its plan (n_split 1 writes the
    output directly; 2, 3 and one tile a chunk merge), extents on and off
    the chunk boundaries, against the plain split arithmetic at the same
    split and the plain version; a split that leaves slots uncovered
    raises."""
    dt = getattr(torch, dtype)
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(dt)
    B, S, H, Hkv, D = 2, 200, 16, 8, 128
    q, kt, vt = rn(B, 1, H, D), rn(B, Hkv, S, D), rn(B, Hkv, S, D)
    valid = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    valid[0, :170] = True
    valid[1, 130:180] = True
    for split in ((1, 256), (2, 128), (3, 128), (4, 64)):
        for extent in (None, 192, 128, [150, 1], [64, 190]):
            ext = (torch.tensor(extent, dtype=torch.int32, device="cuda")
                   if isinstance(extent, list) else extent)
            vm = valid.clone()                   # none past the extent
            if extent is not None:
                e = torch.as_tensor(extent, device="cuda").expand(B)
                vm &= torch.arange(S, device="cuda")[None] < e[:, None]
            out = fa.flash_decode_hs(q, kt, vt, vm, D ** -0.5, extent=ext,
                                     split=split)
            ref = fa.flash_decode_hs_split_plain(
                q, kt, vt, vm, D ** -0.5, extent=ext, n_split=split[0],
                chunk=split[1], out_dtype=torch.float32)
            _close(out, ref, dtype)
            _close(out, fa.flash_decode_hs_plain(
                q, kt, vt, vm, D ** -0.5, extent=ext,
                out_dtype=torch.float32), dtype)
    for bad in ((3, 64), (2, 100), (0, 256)):
        with pytest.raises(ValueError, match="split"):
            fa.flash_decode_hs(q, kt, vt, valid, D ** -0.5, split=bad)


def _two_streams_at_once(gen, int8):
    """Split decodes (B2, or B3 with ``int8``) running on two streams at
    the same time, each held to its plain version. Only the first chunk
    lies below the extent: it walks its tiles while the other chunks take
    their tickets at once, so tickets shared across streams would let a
    block merge before the first chunk's partial is written. Each stream
    first spins the card for ~50 ms, so that all the launches are queued
    before either stream runs."""
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16)
    B, S, H, Hkv, D = 1, 16384, 16, 8, 128
    n_split, chunk = fa.decode_split_plan(B, Hkv, S,
                                          fa.sm_count(torch.device("cuda")))
    assert n_split > 1 and chunk > 64
    valid = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    valid[:, :chunk] = True
    if int8:
        inputs = [(rn(B, 1, H, D), *_int8_cache(gen, (B, Hkv, S, D)),
                   *_int8_cache(gen, (B, Hkv, S, D))) for _ in range(2)]
        kern, plain = fa.flash_decode_int8_hs, fa.flash_decode_int8_hs_plain
    else:
        inputs = [(rn(B, 1, H, D), rn(B, Hkv, S, D), rn(B, Hkv, S, D))
                  for _ in range(2)]
        kern, plain = fa.flash_decode_hs, fa.flash_decode_hs_plain
    streams = [torch.cuda.Stream() for _ in range(2)]
    kern(*inputs[0], valid, D ** -0.5, extent=chunk)            # build
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(100_000_000)
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(kern(*inputs[i], valid, D ** -0.5,
                                    extent=chunk))
    torch.cuda.synchronize()
    for i in range(2):
        ref = plain(*inputs[i], valid, D ** -0.5, extent=chunk,
                    out_dtype=torch.float32)
        for out in outs[i]:
            _close(out, ref, "bfloat16")


def test_decode_split_on_two_streams_at_once(cuda):
    """Split decodes on two streams at once each take the tickets of their
    own stream, so both merge only their own partials."""
    _two_streams_at_once(cuda, int8=False)


def test_int8_decode_split_on_two_streams_at_once(cuda):
    """The same for B3, which takes its tickets from the same per-stream
    counters as B2."""
    _two_streams_at_once(cuda, int8=True)


def test_wrappers_count_launches_and_reject_bad_input(cuda):
    fa.reset_launch_counts()
    q = torch.zeros(1, 3, 4, 16, device="cuda")
    k = torch.zeros(1, 3, 2, 16, device="cuda")
    valid = torch.ones(1, 3, dtype=torch.bool, device="cuda")
    fa.flash_prefill(q, k, k, valid, 0.25)
    assert fa.launch_counts()["flash_prefill"] == 1
    with pytest.raises(ValueError):
        fa.flash_prefill(q.half(), k.half(), k.half(), valid, 0.25)
    with pytest.raises(ValueError):
        fa.flash_prefill(q[..., :12], k[..., :12], k[..., :12], valid, 0.25)


def _int8_cache(gen, shape):
    from moss_ttsd_torch.ops.quantize import quantize_kv
    return quantize_kv(torch.randn(shape, generator=gen, device="cuda"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hkv", [8, 4])              # G = 2 and G = 4
def test_int8_decode_kernel_matches_plain(cuda, dtype, Hkv):
    dt = getattr(torch, dtype)
    B, S, H, D, L = 2, 333, 16, 128, 3
    q = torch.randn(B, 1, H, D, generator=cuda, device="cuda").to(dt)
    kq, ks = _int8_cache(cuda, (L, B, Hkv, S, D))
    vq, vs = _int8_cache(cuda, (L, B, Hkv, S, D))
    valid = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    valid[0, :200] = True
    valid[1, 30:150] = True
    n_split, chunk = fa.decode_split_plan(B, Hkv, S,
                                          fa.sm_count(torch.device("cuda")))
    fa.reset_launch_counts()
    for ext in (200, torch.tensor([200, 150], dtype=torch.int32,
                                  device="cuda"), None, 1):
        out = fa.flash_decode_int8_hs(q, kq, ks, vq, vs, valid, D ** -0.5,
                                      extent=ext, layer=2)
        args = (q, kq, ks, vq, vs, valid, D ** -0.5)
        kw = dict(extent=ext, layer=2, out_dtype=torch.float32, p_dtype=dt)
        _close(out, fa.flash_decode_int8_hs_plain(*args, **kw), dtype)
        _close(out, fa.flash_decode_int8_hs_split_plain(
            *args, n_split=n_split, chunk=chunk, **kw), dtype)
    assert fa.launch_counts()["flash_decode_int8_hs"] == 4   # one a call
    empty = torch.zeros_like(valid)                  # no valid key at all
    for split in (None, (1, 384)):
        out = fa.flash_decode_int8_hs(q, kq[0], ks[0], vq[0], vs[0], empty,
                                      D ** -0.5, extent=S, split=split)
        assert bool((out == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_kernel_at_every_split(cuda, dtype):
    """B3 at splits other than its plan (n_split 1 writes the output
    directly; 2, 3 and one tile a chunk merge), extents on and off the
    chunk boundaries, a chunk inside the extent with no valid key, against
    the plain split arithmetic at the same split and the plain version; a
    split that leaves slots uncovered raises."""
    dt = getattr(torch, dtype)
    B, S, H, Hkv, D = 2, 200, 16, 8, 128
    q = torch.randn(B, 1, H, D, generator=cuda, device="cuda").to(dt)
    kq, ks = _int8_cache(cuda, (B, Hkv, S, D))
    vq, vs = _int8_cache(cuda, (B, Hkv, S, D))
    valid = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    valid[0, :170] = True
    valid[1, 130:180] = True
    for split in ((1, 256), (2, 128), (3, 128), (4, 64)):
        for extent in (None, 192, 128, [150, 1], [64, 190]):
            ext = (torch.tensor(extent, dtype=torch.int32, device="cuda")
                   if isinstance(extent, list) else extent)
            vm = valid.clone()                   # none past the extent
            if extent is not None:
                e = torch.as_tensor(extent, device="cuda").expand(B)
                vm &= torch.arange(S, device="cuda")[None] < e[:, None]
            args = (q, kq, ks, vq, vs, vm, D ** -0.5)
            kw = dict(extent=ext, out_dtype=torch.float32, p_dtype=dt)
            out = fa.flash_decode_int8_hs(*args, extent=ext, split=split)
            _close(out, fa.flash_decode_int8_hs_split_plain(
                *args, n_split=split[0], chunk=split[1], **kw), dtype)
            _close(out, fa.flash_decode_int8_hs_plain(*args, **kw), dtype)
    for bad in ((3, 64), (2, 100), (0, 256)):
        with pytest.raises(ValueError, match="split"):
            fa.flash_decode_int8_hs(q, kq, ks, vq, vs, valid, D ** -0.5,
                                    split=bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_split_boundaries(cuda, dtype):
    """B3 at its plan's chunk boundaries: S 4096 and the long form's 1557,
    extents exactly at and one past a chunk edge, a whole in-extent chunk
    with no valid key, a row with no valid key, batch 8, a layer view of
    the stack — against the plain version and the plain split arithmetic
    at the kernel's plan."""
    dt = getattr(torch, dtype)
    H, Hkv, D = 16, 8, 128
    sms = fa.sm_count(torch.device("cuda"))
    for B, S in ((2, 4096), (1, 1557), (8, 633)):
        n_split, chunk = fa.decode_split_plan(B, Hkv, S, sms)
        assert n_split > 1 and B * Hkv * n_split >= sms
        q = torch.randn(B, 1, H, D, generator=cuda, device="cuda").to(dt)
        kq, ks = _int8_cache(cuda, (3, B, Hkv, S, D))
        vq, vs = _int8_cache(cuda, (3, B, Hkv, S, D))
        for lo, hi in ((0, chunk), (0, chunk + 1), (2 * chunk + 3, S - 7),
                       (0, S), (0, 0)):
            valid = torch.zeros(B, S, dtype=torch.bool, device="cuda")
            valid[0, lo:hi] = True
            valid[1:, :max(hi, 1)] = True
            ext = torch.full((B,), max(hi, 1), dtype=torch.int32,
                             device="cuda")
            args = (q, kq, ks, vq, vs, valid, D ** -0.5)
            kw = dict(extent=ext, layer=2, out_dtype=torch.float32,
                      p_dtype=dt)
            out = fa.flash_decode_int8_hs(*args, extent=ext, layer=2)
            _close(out, fa.flash_decode_int8_hs_plain(*args, **kw), dtype)
            _close(out, fa.flash_decode_int8_hs_split_plain(
                *args, n_split=n_split, chunk=chunk, **kw), dtype)
            if hi == 0:
                assert bool((out[0] == 0).all())


def _decode_p_rounding_inputs(gen, B, S, H, Hkv, D):
    """The decode form of ``_p_rounding_inputs`` (scores the row max on
    even keys, 2^-10 below it on odd ones; v = +c / -c, c in [32, 64)), as
    a bf16 cache (q, kt, vt) and as an int8 one (kq = kt, ks = 1, vq = 2 vt,
    vs = 1/2: powers of two, so p * vs rounds as p does). With as many
    valid even keys as odd, every row is exactly 0 with bf16 P and
    ~c 2^-11 (>= 0.0156) with fp32 P."""
    q = torch.zeros((B, 1, H, D), device="cuda")
    q[..., 0], q[..., 1] = 1.0, 2.0 ** -10
    kt = torch.zeros((B, Hkv, S, D), device="cuda")
    kt[..., 0] = 1.0
    kt[:, :, 1::2, 1] = -1.0
    c = torch.randint(64, 128, (B, Hkv, 1, D), generator=gen, device="cuda")
    c = c * (2 * torch.randint(0, 2, c.shape, generator=gen, device="cuda")
             - 1)
    vq = (c * (1 - 2 * (torch.arange(S, device="cuda") % 2))[:, None]
          ).to(torch.int8)
    ones = torch.ones((B, Hkv, S), device="cuda")
    bf = torch.bfloat16
    return {"hs": (q.to(bf), kt.to(bf), (vq.float() / 2).to(bf)),
            "int8": (q.to(bf), kt.to(torch.int8), ones, vq, ones / 2)}


@pytest.mark.parametrize("kind", ["hs", "int8"])
def test_decode_bf16_rounds_p_like_the_tpu_kernel(cuda, kind):
    """B2 rounds P, and B3 p * vs, to bf16 before P.V, as the TPU kernels
    do: within 1e-3 + 2^-8 |ref| of the bf16-P plain version on inputs
    where the rounding moves every row by >= 0.0156, which the fp32-P
    plain version therefore misses."""
    B, S = 2, 1557
    args = _decode_p_rounding_inputs(cuda, B, S, 16, 8, 128)[kind]
    valid = torch.ones(B, S, dtype=torch.bool, device="cuda")
    valid[:, 800:] = False                   # as many even keys as odd
    valid[1, :6] = False
    kern, plain = ((fa.flash_decode_hs, fa.flash_decode_hs_plain)
                   if kind == "hs" else
                   (fa.flash_decode_int8_hs, fa.flash_decode_int8_hs_plain))
    out = kern(*args, valid, 1.0, extent=800).float()
    excess = {}
    for p_dtype in (torch.bfloat16, None):
        ref = plain(*args, valid, 1.0, extent=800, out_dtype=torch.float32,
                    p_dtype=p_dtype)
        excess[p_dtype] = float(((out - ref).abs()
                                 - 2.0 ** -8 * ref.abs()).max())
    assert excess[torch.bfloat16] <= 1e-3 < excess[None]
    assert bool((out == 0).all())


def test_quantize_kv_on_card_matches_cpu(cuda):
    from moss_ttsd_torch.ops.quantize import quantize_kv
    x = torch.randn(2, 8, 57, 128, generator=cuda, device="cuda") * 3
    x[1, 2, 5] = 0.0
    for xx in (x, x.to(torch.bfloat16)):
        qg, sg = quantize_kv(xx)
        qc, sc = quantize_kv(xx.cpu())
        assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)


@pytest.mark.parametrize("policy", [{}, dict(quant="int8", kv_quant="int8")])
def test_tiny_engine_on_card_matches_cpu(cuda, policy):
    """Greedy tokens of the tiny fp32 engine: kernels on the card ==
    plain versions on the CPU (the bf16 path and int8 serving)."""
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             LMConfig, SamplingConfig)
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.lm import AsteroidLM
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny()
    greedy = SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=False, temperature=None, top_k=None, top_p=None)
        for _ in range(cfg.channels)], max_new_tokens=12)
    rng = np.random.default_rng(0)
    prompt = np.full((2, 20, cfg.channels), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[0, :5] = 0
    toks = []
    for dev in ("cpu", "cuda"):
        model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
        eng = GenerationEngine(cfg, model, greedy, bucket=32, device=dev,
                               **policy)
        toks.append(eng.generate(prompt, mask, 12).tokens)
    np.testing.assert_array_equal(toks[1], toks[0])


@pytest.mark.parametrize("fields,kw", [
    ({}, dict(attn_impl="xla")),
    ({}, dict(attn_impl="xla", quant="int8", kv_quant="int8")),
    (dict(ablate_norms=True), {}), (dict(ablate_rope=True), {}),
    (dict(ablate_attention=True), {}),
    (dict(ablate_norms=True, ablate_rope=True, ablate_attention=True), {})],
    ids=["xla", "xla_int8_kv8", "ablate_norms", "ablate_rope",
         "ablate_attention", "ablate_all"])
def test_tiny_engine_variants_on_card_match_cpu(cuda, fields, kw):
    """The dense backend and the bench-only stubs on the card: greedy
    tokens of the tiny fp32 engine equal the CPU's; under xla no kernel
    of csrc/ runs, under a stub the kernels still do (but no attention
    kernel decodes under ablate_attention)."""
    import dataclasses
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             LMConfig, SamplingConfig)
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.lm import AsteroidLM
    cfg = dataclasses.replace(
        LMConfig(dtype="float32", param_dtype="float32").tiny(), **fields)
    greedy = SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=False, temperature=None, top_k=None, top_p=None)
        for _ in range(cfg.channels)], max_new_tokens=12)
    rng = np.random.default_rng(0)
    prompt = np.full((2, 20, cfg.channels), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[0, :5] = 0
    toks = []
    for dev in ("cpu", "cuda"):
        model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
        eng = GenerationEngine(cfg, model, greedy, bucket=32, device=dev,
                               **kw)
        fa.reset_launch_counts()
        toks.append(eng.generate(prompt, mask, 12).tokens)
    counts = fa.launch_counts()
    if kw.get("attn_impl") == "xla" or cfg.ablate_attention:
        assert not any(counts.values()), counts
    else:
        assert counts["flash_prefill"] and counts["flash_decode_hs"], counts
    np.testing.assert_array_equal(toks[1], toks[0])


def test_codec_encode_on_card_matches_cpu(cuda):
    """The tiny fp32 codec encode (log-mel, both encoders, RVQ) of the
    examples' voices on the card against the same weights on the CPU, TF32
    off: the pre-RVQ latents within 1e-4, the codes identical."""
    import pathlib
    from moss_ttsd_torch.core.config import CodecConfig
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.utils.audio_io import read_wav
    ex = pathlib.Path(__file__).resolve().parents[1] / "examples"
    wavs = [np.concatenate([read_wav(str(ex / n))[0][0]
                            for n in ("voice_s1.wav", "voice_s2.wav")]),
            read_wav(str(ex / "voice_both.wav"))[0][0]]
    cfg = CodecConfig().tiny()
    cpu = XYTokenizer.init_random(cfg, seed=0, device="cpu")
    gpu = XYTokenizer(cfg, {k: v.clone() for k, v in
                            cpu.module.state_dict().items()}, device="cuda")
    x = np.zeros((2, cpu.chunk_samples), np.float32)
    for b, w in enumerate(wavs):
        x[b, :len(w)] = w
    lens = np.array([len(w) for w in wavs])
    with torch.no_grad():
        lat = [spt.module._encode_latents(
            torch.as_tensor(x, device=spt.device),
            torch.as_tensor(lens, device=spt.device))[0].cpu()
            for spt in (cpu, gpu)]
    assert float((lat[0] - lat[1]).abs().max()) <= 1e-4
    for a, b in zip(cpu.encode(wavs)["codes_list"],
                    gpu.encode(wavs)["codes_list"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("do_sample", [False, True])
def test_generate_stream_on_card_equals_generate(cuda, do_sample):
    """generate_stream on the card, in segments over one state and one
    generator: the tokens of generate with the same seed, greedy and
    sampled, and the segments end at the boundaries."""
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             LMConfig, SamplingConfig)
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.lm import AsteroidLM
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny(
        speech_token_range=(0, 160))
    sampling = SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=do_sample, temperature=0.9 if do_sample else None,
        top_k=20 if do_sample else None, top_p=0.9 if do_sample else None)
        for _ in range(cfg.channels)], max_new_tokens=30)
    rng = np.random.default_rng(1)
    prompt = np.full((2, 20, cfg.channels), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[1, :7] = 0
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    with torch.no_grad():       # EOS logit 0: the rows decode all 30 steps
        model.embed_text[cfg.eos_token_id] = 0.0
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cuda")
    full = eng.generate(prompt, mask, 30, seed=3)
    res = list(eng.generate_stream(prompt, mask, 30, seed=3,
                                   boundaries=[12, 25]))
    assert [r.steps for r in res] == [12, 25, 30] and full.steps == 30
    np.testing.assert_array_equal(res[-1].tokens, full.tokens)


def _pool_rows(B, S, base):
    """Ring-addressed valid bits of a pool of B rows (prefix left pads,
    then each row's own wrapped span of the ring) and the pool's per-row
    extent: the last valid slot + 1, 1 for the rows that do not advance."""
    g = np.random.default_rng(0)
    ring = S - base
    valid = np.zeros((B, S), bool)
    ext = np.ones(B, np.int32)
    for b in range(B):
        valid[b, g.integers(0, base // 2):base] = True
        start, n = g.integers(0, ring), g.integers(1, ring)
        valid[b, base + (start + np.arange(n)) % ring] = True
        if b % 4 != 3:                          # every 4th row is frozen
            ext[b] = np.nonzero(valid[b])[0].max() + 1
    return (torch.from_numpy(valid).cuda(),
            torch.from_numpy(ext).cuda())


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_decode_tensor_extent_at_pool_shape(cuda, kind):
    """B2 / B3 at the pool's (8, 2560) with a (B,) int32 extent (each row
    its own; frozen rows 1) over ring-addressed valid bits and a layer view
    of a 2-layer stack: kernel against its plain version."""
    B, S, H, Hkv, D, base = 8, 2560, 16, 8, 128, 512
    bf = torch.bfloat16
    q = torch.randn(B, 1, H, D, generator=cuda, device="cuda").to(bf)
    valid, ext = _pool_rows(B, S, base)
    shape = (2, B, Hkv, S, D)
    if kind == "bf16":
        k, v = (torch.randn(shape, generator=cuda, device="cuda").to(bf)
                for _ in range(2))
        out = fa.flash_decode_hs(q, k, v, valid, D ** -0.5, extent=ext,
                                 layer=1)
        ref = fa.flash_decode_hs_plain(q, k, v, valid, D ** -0.5, extent=ext,
                                       layer=1, p_dtype=bf,
                                       out_dtype=torch.float32)
    else:
        from moss_ttsd_torch.ops.quantize import quantize_kv
        k, ks = quantize_kv(torch.randn(shape, generator=cuda, device="cuda"))
        v, vs = quantize_kv(torch.randn(shape, generator=cuda, device="cuda"))
        out = fa.flash_decode_int8_hs(q, k, ks, v, vs, valid, D ** -0.5,
                                      extent=ext, layer=1)
        ref = fa.flash_decode_int8_hs_plain(q, k, ks, v, vs, valid,
                                            D ** -0.5, extent=ext, layer=1,
                                            p_dtype=bf,
                                            out_dtype=torch.float32)
    _close(out, ref, "bfloat16")


def _tiny_pool_parts(do_sample=False):
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             LMConfig, SamplingConfig)
    from moss_ttsd_torch.models.lm import AsteroidLM
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny(
        speech_token_range=(0, 160))
    sampling = SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=do_sample, temperature=0.9 if do_sample else None,
        top_k=20 if do_sample else None, top_p=0.9 if do_sample else None)
        for _ in range(cfg.channels)], max_new_tokens=30)
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    with torch.no_grad():       # EOS logit 0: rows decode their budgets
        model.embed_text[cfg.eos_token_id] = 0.0
    rng = np.random.default_rng(2)
    prompts = []
    for n in (14, 20, 9):
        p = np.full((n, cfg.channels), cfg.speech_pad_token, np.int64)
        p[:, 0] = rng.integers(1, 90, n)
        prompts.append(p)
    return cfg, sampling, model, prompts


def _drive_pool(cb, prompts, budgets, seeds, adapters):
    slots = []
    for i, (p, b, s, a) in enumerate(zip(prompts, budgets, seeds, adapters)):
        if i:
            cb.run(steps=3 + 2 * i)
        slots.append(cb.submit(p, max_new_tokens=b, seed=s, adapter=a))
    for _ in range(20):
        cb.run(steps=5)
        if len(cb.finished()) == len(slots):
            break
    return [cb.collect(s).tokens for s in slots]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tiny_pool_on_card_matches_cpu(cuda, kv_quant):
    """The continuous pool (gated ring writes, tensor extents into B2 / B3,
    per-row LoRA adapters) on the card against the same pool on the CPU:
    staggered joins, greedy, fp32 with TF32 off, identical tokens."""
    from moss_ttsd_torch.decode.continuous import ContinuousBatcher
    cfg, sampling, model, prompts = _tiny_pool_parts()
    g = np.random.default_rng(3)
    L, hid = cfg.num_hidden_layers, cfg.hidden_size
    qd = cfg.num_attention_heads * cfg.head_dim
    lora = {"layers/block/q_proj/kernel": {
        "a": g.standard_normal((L, hid, 2)).astype(np.float32) * 0.1,
        "b": g.standard_normal((L, 2, qd)).astype(np.float32) * 0.3}}
    out = []
    for dev in ("cpu", "cuda"):
        cb = ContinuousBatcher(cfg, model, sampling, slots=3, base=24,
                               max_steps=40, device=dev, kv_quant=kv_quant)
        cb.register_adapter("v1", lora, alpha=8.0)
        out.append(_drive_pool(cb, prompts, [30, 24, 28], [0, 0, 0],
                               [None, "v1", None]))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_sampled_pool_row_on_card_equals_generate(cuda):
    """Per-row generators on the card: a sampled row joined mid-flight
    equals the card's isolated batch-1 generate with its seed."""
    from moss_ttsd_torch.decode.continuous import ContinuousBatcher
    from moss_ttsd_torch.decode.engine import GenerationEngine
    cfg, sampling, model, prompts = _tiny_pool_parts(do_sample=True)
    cb = ContinuousBatcher(cfg, model, sampling, slots=3, base=24,
                           max_steps=40, device="cuda")
    got = _drive_pool(cb, prompts, [30, 24, 28], [5, 6, 7],
                      [None, None, None])
    eng = GenerationEngine(cfg, model, sampling, bucket=24 + cfg.channels - 1,
                           step_bucket=40, device="cuda")
    for p, b, s, g in zip(prompts, [30, 24, 28], [5, 6, 7], got):
        ref = eng.generate(p[None], np.ones((1, len(p)), np.int64), b,
                           seed=s)
        np.testing.assert_array_equal(g[0, ref.base:],
                                      ref.tokens[0, ref.base:])


def _train_batch(cfg, seed=0, B=4, T=32):
    g = np.random.default_rng(seed)
    ids = g.integers(0, cfg.speech_vocab_size, (B, T, cfg.channels))
    ids[..., 0] = g.integers(0, cfg.vocab_size, (B, T))
    labels = ids.copy()
    for b in range(B):
        labels[b, : 3 + 2 * b] = -100
    mask = np.ones((B, T), np.int64)
    mask[-1, T - 5:] = 0
    return {k: v.reshape((2, B // 2) + v.shape[1:]) for k, v in
            (("input_ids", ids), ("labels", labels),
             ("attention_mask", mask))}


@pytest.mark.parametrize("lora", [False, True])
def test_tiny_train_steps_on_card_match_cpu(cuda, lora):
    """Two optimizer steps (cosine with a warmup step, weight decay, K 2
    accumulation, remat) of full finetuning or layerwise LoRA, fp32 with
    TF32 off, on the card and on the CPU from the same weights: losses
    within rel 1e-5 and every parameter within rel 1e-4 (atol 1e-6) but a
    few elements whose gradient sits within rounding of zero, those within
    one update (lr)."""
    import dataclasses
    from moss_ttsd_torch.cli.inference import tiny_lm_config
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.train import lora as tl
    from moss_ttsd_torch.train.step import (init_train_state, make_optimizer,
                                            make_train_step)
    cfg = tiny_lm_config()
    lcfg = dataclasses.replace(cfg, lora_rank=4, lora_alpha=8.0)
    batch = _train_batch(cfg)
    lr = 1e-3
    out = []
    for dev in ("cpu", "cuda"):
        opt = make_optimizer(learning_rate=lr, warmup_ratio=0.1,
                             total_steps=10, weight_decay=0.01)
        model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
        if lora:
            model = tl.graft_lora_params(model, lcfg, seed=1).to(dev)
            state = tl.init_lora_state(model, opt)
            step = tl.make_layerwise_lora_step(lcfg, opt, remat=True,
                                               ce_chunks=2, grad_accum_steps=2)
        else:
            model = model.to(dev)
            state = init_train_state(cfg, opt, model=model)
            step = make_train_step(cfg, opt, remat=True, ce_chunks=2,
                                   grad_accum_steps=2)
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
        assert next(model.parameters()).device.type == dev
        out.append((losses, {k: v.detach().cpu() for k, v in
                             model.state_dict().items()}))
    (lc, sc), (lg, sg) = out
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for k, want in sc.items():
        err = (sg[k] - want).abs()
        outside = int((err > 1e-4 * want.abs() + 1e-6).sum())
        assert outside <= max(4, want.numel() // 1000), (k, outside)
        assert float(err.max()) <= lr, (k, float(err.max()))


def test_tiny_codec_train_steps_on_card_match_cpu(cuda):
    """The codec's k-means bootstrap and two train steps (dropout, skip,
    dead-code replacement; AdamW and the EMA codebooks) in fp32 with TF32
    off, every draw pinned, on the card and on the CPU from the same
    weights: losses and grad norms within rel 1e-5, the EMA state within
    1e-5, every parameter as in the LM's card-vs-CPU test."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_codec_train_ref as tref
    cpu, gpu = tref.pinned_run("cpu"), tref.pinned_run("cuda")
    for k in ("loss", "wave_l1", "mel_l1", "commit", "grad_norm"):
        np.testing.assert_allclose(gpu[k], cpu[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in ("cluster_size", "embed_avg", "param/quantizer.codebook"):
        np.testing.assert_allclose(gpu[k], cpu[k], atol=1e-5, err_msg=k)
    for k, want in cpu.items():
        if k.startswith("param/"):
            err = np.abs(gpu[k] - want)
            outside = int((err > 1e-4 * np.abs(want) + 1e-6).sum())
            assert outside <= max(4, want.size // 1000), (k, outside)
            assert float(err.max()) <= tref.LR, (k, float(err.max()))


def _greedy_sampling(channels: int, n: int = 12):
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             SamplingConfig)
    return SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=False, temperature=None, top_k=None, top_p=None)
        for _ in range(channels)], max_new_tokens=n)


@pytest.mark.parametrize("policy", [{}, dict(quant="int8", kv_quant="int8")])
def test_loaded_lm_on_card_equals_in_memory(cuda, tmp_path, policy):
    """A checkpoint directory written by ``save_asteroid_checkpoint`` and
    read by ``load_asteroid_checkpoint`` straight onto the card gives the
    greedy tokens of the in-memory model (fp32; and int8 serving)."""
    from moss_ttsd_torch.core.config import LMConfig
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.utils.convert_lm import (load_asteroid_checkpoint,
                                                  save_asteroid_checkpoint)
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny()
    model = AsteroidLM.init_random(cfg, seed=1, device="cuda")
    save_asteroid_checkpoint(model, cfg, str(tmp_path), shards=2)
    state = load_asteroid_checkpoint(str(tmp_path), cfg, device="cuda")
    assert all(v.device.type == "cuda" for v in state.values())
    rng = np.random.default_rng(1)
    prompt = np.full((2, 20, cfg.channels), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[1, :6] = 0
    toks = [GenerationEngine(cfg, w, _greedy_sampling(cfg.channels),
                             bucket=32, device="cuda", **policy
                             ).generate(prompt, mask, 12).tokens
            for w in (model, state)]
    np.testing.assert_array_equal(toks[1], toks[0])


def test_loaded_codec_on_card_matches_cpu(cuda, tmp_path):
    """The reference-format codec .ckpt loaded on the card and on the CPU
    (fp32, TF32 off): identical codes; the card's bf16 decode of those
    codes within the codec's bf16 contract (3 % relative RMS) of its fp32
    decode."""
    import pathlib
    import torch_ref_codec
    from moss_ttsd_torch.core.config import CodecConfig
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.utils.audio_io import read_wav
    yaml_path, ckpt = torch_ref_codec.write_reference_codec(
        str(tmp_path), CodecConfig().tiny(), seed=0)
    ex = pathlib.Path(__file__).resolve().parents[1] / "examples"
    wavs = [read_wav(str(ex / n))[0][0] for n in ("voice_s1.wav",
                                                   "voice_both.wav")]
    spts = [XYTokenizer.load_from_checkpoint(yaml_path, ckpt, device=d)
            for d in ("cpu", "cuda")]
    codes = [s.encode(wavs)["codes_list"] for s in spts]
    for a, b in zip(*codes):
        np.testing.assert_array_equal(a, b)
    b16 = XYTokenizer.load_from_checkpoint(yaml_path, ckpt,
                                           dtype="bfloat16", device="cuda")
    for a, b in zip(spts[1].decode(codes[1])["syn_wav_list"],
                    b16.decode(codes[1])["syn_wav_list"]):
        assert np.isfinite(b).all() and a.shape == b.shape
        assert np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-9) < 0.03


@pytest.mark.parametrize("vocos_kw", [
    dict(backbone="resnet", num_blocks=2, head="imdct_symexp",
         head_sample_rate=24000),
    dict(head="imdct_cos", padding="center"),
    dict(adanorm_num_embeddings=3, head="imdct_symexp", clip_audio=True)],
    ids=["resnet-symexp", "cos-center", "adanorm-symexp-clip"])
def test_vocos_variants_on_card_match_cpu(cuda, vocos_kw):
    """Each Vocos variant on the card (fp32, TF32 off) against the same
    weights on the CPU: wav within 1e-4, lengths equal."""
    import dataclasses
    from moss_ttsd_torch.core.config import VocosConfig
    from moss_ttsd_torch.models.codec.vocos import Vocos
    cfg = VocosConfig(input_channels=80, dim=64, intermediate_dim=128,
                      num_layers=3, **vocos_kw)
    torch.manual_seed(0)
    cpu = Vocos(cfg).eval()
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn_like(p))
    gpu = Vocos(dataclasses.replace(cfg)).to("cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 50, 80)
    lens = torch.tensor([50, 31])
    cond = (None if cfg.adanorm_num_embeddings is None
            else torch.tensor([[0], [2]]))
    with torch.no_grad():
        w_c, l_c = cpu(x, lens, cond)
        w_g, l_g = gpu(x.cuda(), lens.cuda(),
                       None if cond is None else cond.cuda())
    assert torch.equal(l_g.cpu(), l_c)
    assert float((w_g.cpu() - w_c).abs().max()) <= 1e-4


def test_podcast_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """process_input_to_audio on a .txt source (the fallback script, both
    default voices cloned) with the tiny fp32 greedy pipeline: the same
    prompt ids and tokens on the card (kernels) as on the CPU (plain
    versions), TF32 off, and a finite wav of frames x the codec's hop."""
    from moss_ttsd_torch.cli.inference import tiny_lm_config
    from moss_ttsd_torch.core.config import CodecConfig
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.serve import podcast
    from moss_ttsd_torch.utils.audio_io import read_wav
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    monkeypatch.delenv("PODCAST_LLM_BASE", raising=False)
    src = tmp_path / "notes.txt"
    src.write_text("A short note about speech codecs and language models.")
    cfg, ccfg = tiny_lm_config(), CodecConfig().tiny()
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    spt = XYTokenizer.init_random(ccfg, seed=0, device="cpu")
    runs = []
    for dev in ("cpu", "cuda"):
        pipe = TTSPipeline(
            MockTokenizer(), cfg, model,
            XYTokenizer(ccfg, {k: v.clone() for k, v in
                               spt.module.state_dict().items()}, device=dev),
            _greedy_sampling(cfg.channels, 24), bucket=32, device=dev)
        seen = []
        orig = pipe.engine.generate
        pipe.engine.generate = lambda *a, **kw: seen.append(
            (np.asarray(a[0]), orig(*a, **kw))) or seen[-1][1]
        fa.reset_launch_counts()
        info = podcast.process_input_to_audio(
            str(src), pipe, str(tmp_path / f"{dev}.wav"))
        runs.append((info, seen[-1], fa.launch_counts()))
    (info, (ids, res), _), (ginfo, (gids, gres), counts) = runs
    assert info["script"] == ginfo["script"] == podcast.FALLBACK_SCRIPT_EN
    np.testing.assert_array_equal(gids, ids)
    np.testing.assert_array_equal(gres.tokens, res.tokens)
    assert counts["flash_prefill"] > 0 and counts["flash_decode_hs"] > 0
    wav, sr = read_wav(str(tmp_path / "cuda.wav"))
    assert sr == 24000 and np.isfinite(wav).all()
    assert wav.shape[-1] == round(ginfo["duration_s"] * sr) > 0
    assert wav.shape[-1] % 1920 == 0


# -- tensor-parallel rank shapes and the NCCL mesh ---------------------------------

@pytest.mark.parametrize("H,Hkv", [(8, 4), (4, 2), (1, 1)],
                         ids=["tp2", "tp4", "g1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_at_tensor_parallel_rank_shapes(cuda, H, Hkv, dtype):
    """A rank's heads of the model's 16 / 8 at tp 2 and 4, and G 1 (tp 16:
    one query head and its replicated KV head): B1, B2 and B3 against
    their plain versions, B2 and B3 also against the plain split at their
    own plan (the plans change with Hkv)."""
    dt = getattr(torch, dtype)
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(dt)
    B, T, S, D = 2, 121, 633, 128
    q, k, v = rn(B, T, H, D), rn(B, T, Hkv, D), rn(B, T, Hkv, D)
    valid = torch.ones(B, T, dtype=torch.bool, device="cuda")
    valid[1, :40] = False
    out = fa.flash_prefill(q, k, v, valid, D ** -0.5)
    _close(out, fa.flash_prefill_plain(q, k, v, valid, D ** -0.5,
                                       out_dtype=torch.float32), dtype)
    qd, kt, vt = rn(B, 1, H, D), rn(B, Hkv, S, D), rn(B, Hkv, S, D)
    kv = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    kv[0, :505] = True
    kv[1, 92:505] = True
    kq, ks = _int8_cache(cuda, (B, Hkv, S, D))
    vq, vs = _int8_cache(cuda, (B, Hkv, S, D))
    n_split, chunk = fa.decode_split_plan(B, Hkv, S,
                                          fa.sm_count(torch.device("cuda")))
    for name, args in (("flash_decode_hs", (qd, kt, vt)),
                       ("flash_decode_int8_hs", (qd, kq, ks, vq, vs))):
        a = (*args, kv, D ** -0.5)
        kw = dict(extent=505, out_dtype=torch.float32, p_dtype=dt)
        got = getattr(fa, name)(*a, extent=505)
        _close(got, getattr(fa, name + "_plain")(*a, **kw), dtype)
        _close(got, getattr(fa, name + "_split_plain")(
            *a, n_split=n_split, chunk=chunk, **kw), dtype)


def test_nccl_mesh_of_one_engine_equals_unsharded(cuda, tmp_path):
    """A world of one over NCCL: the tiny engine on a 1x1 mesh (parse_mesh_
    arg) gives the unsharded engine's greedy tokens; the mesh of the
    wrong size is refused."""
    import torch.distributed as dist
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             LMConfig, SamplingConfig)
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.parallel.distributed import initialize_multihost
    from moss_ttsd_torch.parallel.mesh import make_mesh, parse_mesh_arg
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny()
    greedy = SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=False, temperature=None, top_k=None, top_p=None)
        for _ in range(cfg.channels)], max_new_tokens=12)
    rng = np.random.default_rng(1)
    prompt = np.full((2, 20, cfg.channels), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[1, :3] = 0
    assert initialize_multihost("file://" + str(tmp_path / "store"), 1, 0,
                                device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        with pytest.raises(ValueError, match="needs 2 processes"):
            parse_mesh_arg("1x2")
        model = AsteroidLM.init_random(cfg, seed=0, device="cuda")
        toks = [GenerationEngine(cfg, model, greedy, bucket=32, mesh=m
                                 ).generate(prompt, mask, 12).tokens
                for m in (None, parse_mesh_arg("1x1"), make_mesh(1, 1))]
        np.testing.assert_array_equal(toks[1], toks[0])
        np.testing.assert_array_equal(toks[2], toks[0])
    finally:
        dist.destroy_process_group()


# -- sequence parallelism and GPipe ---------------------------------------------

def test_sp_and_pp_steps_on_card_match_cpu(cuda, tmp_path):
    """A tiny 4-layer fp32 model (TF32 off): sequence parallelism over a
    (1, 2) mesh and GPipe over two stages, each as two gloo processes
    sharing the card (``tests/torch_mesh_ref.py``), 2 steps against one
    process's plain step on the CPU on the same rows: losses and grad
    norms within rel 1e-5, the parameters within rel 1e-4 (atol 1e-6) but
    a few elements whose gradient sits within rounding of zero, those
    within one update."""
    import torch_mesh_ref as R
    from moss_ttsd_torch.core.config import LMConfig
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.train.step import (init_train_state, make_optimizer,
                                            make_train_step)
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny(
        num_hidden_layers=4)
    batch = {k: v.reshape((4,) + v.shape[2:])
             for k, v in _train_batch(cfg).items()}
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    inp = str(tmp_path / "inputs.pt")
    torch.save({"cfg": cfg.to_dict(), "state": model.state_dict(),
                "train_batch": batch, "pp_batch": batch}, inp)
    opt = make_optimizer(learning_rate=R.LR, total_steps=10,
                         warmup_ratio=0.0, lr_scheduler_type="constant")
    state = init_train_state(cfg, opt, model=model)
    step = make_train_step(cfg, opt, remat=False, ce_chunks=2)
    want = R._run_steps(step, state, batch, 2)
    want["params"] = R._numpy(model.state_dict())
    env = {"MOSS_RANK_DEVICE": "cuda"}
    sp = R.spawn(2, R.sp_train_cases, str(tmp_path / "sp"), inp,
                 [("sp", 1, 2, 1, True)], 2, env=env)
    pp = R.spawn(2, R.pp_train_cases, str(tmp_path / "pp"), inp,
                 [("pp", 2, 1, 2, True, "")], 2, env=env)
    got = [r["sp"] for r in sp] + [r["pp"] for r in pp]
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
    for params in (got[0]["params"], got[2]["params"]):
        for k, w in want["params"].items():
            err = np.abs(params[k] - w)
            outside = int((err > 1e-4 * np.abs(w) + 1e-6).sum())
            assert outside <= max(4, w.size // 1000), (k, outside)
            assert float(err.max()) <= R.LR, (k, float(err.max()))
