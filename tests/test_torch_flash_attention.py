"""The port's flash attention: the plain versions (what the wrappers run on
CPU tensors) against the JAX Pallas kernels in interpret mode, on the case
list of tests/test_pallas_attention.py, at the same tolerances. The CUDA
kernels themselves are tested in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.ops import pallas_attention as jpa  # noqa: E402
from moss_ttsd_torch.ops import flash_attention as fa  # noqa: E402

ATOL = 3e-5      # fp32 interpret-mode kernels vs dense math (reassociation)


def make_qkv(rng, B, Tq, S, H, Hkv, D):
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


T_ = torch.from_numpy


@pytest.mark.parametrize("B,T,H,Hkv,D,bq,bk,pad", [
    (2, 96, 8, 4, 16, 32, 32, 20),     # left padding, causal blocks
    (1, 50, 4, 2, 8, 32, 32, 0),       # ragged T
    (1, 50, 4, 2, 8, 24, 32, 0),       # ragged T, unequal blocks
    (2, 121, 8, 2, 32, 64, 64, 7),
    (2, 7, 4, 2, 16, 256, 256, 3),
    (1, 1, 4, 2, 16, 256, 256, 0),
])
def test_prefill_plain_matches_jax_kernel(B, T, H, Hkv, D, bq, bk, pad):
    rng = np.random.default_rng(B * 1000 + T)
    q, k, v = make_qkv(rng, B, T, T, H, Hkv, D)
    valid = np.ones((B, T), bool)
    valid[-1, :pad] = False
    scale = D ** -0.5
    ref = np.asarray(jpa.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(valid),
                                       scale, block_q=bq, block_k=bk,
                                       interpret=True))
    out = fa.flash_prefill(T_(q), T_(k), T_(v), T_(valid), scale).numpy()
    # left-padded query rows have no valid key: their values are
    # unspecified in the TPU kernel (block-dependent), 0 in the port
    np.testing.assert_allclose(out[:-1], ref[:-1], atol=ATOL)
    np.testing.assert_allclose(out[-1, pad:], ref[-1, pad:], atol=ATOL)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[-1, :pad], 0.0)


def test_prefill_fully_masked_rows_finite():
    """Rows with no valid key (left padding) come out finite (0), so a
    masked slot never carries NaN into the next layer's p @ v."""
    rng = np.random.default_rng(4)
    q, k, v = make_qkv(rng, 2, 40, 40, 4, 2, 16)
    valid = np.ones((2, 40), bool)
    valid[0, :40] = False          # a row with no valid key at all
    valid[1, :13] = False
    out = fa.flash_prefill(T_(q), T_(k), T_(v), T_(valid), 0.25).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[0], 0.0)


@pytest.mark.parametrize("B,S,H,Hkv,D,bk,spans", [
    (2, 64, 8, 4, 16, 32, [(0, 40), (5, 50)]),   # left padding + partial fill
    (1, 16, 4, 2, 8, 64, [(0, 16)]),             # single block
    (2, 96, 16, 8, 32, 32, [(0, 1), (3, 95)]),   # one-slot row, 3 blocks
])
def test_decode_plain_matches_jax_kernel(B, S, H, Hkv, D, bk, spans):
    rng = np.random.default_rng(S)
    q, k, v = make_qkv(rng, B, 1, S, H, Hkv, D)
    kt, vt = np.moveaxis(k, 2, 1).copy(), np.moveaxis(v, 2, 1).copy()
    valid = np.zeros((B, S), bool)
    for b, (lo, hi) in enumerate(spans):
        valid[b, lo:hi] = True
    scale = D ** -0.5
    ref = np.asarray(jpa.flash_decode_hs(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(valid),
        scale, block_k=bk, interpret=True))
    out = fa.flash_decode_hs(T_(q), T_(kt), T_(vt), T_(valid), scale).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_decode_extent_and_layer_match_jax_kernel():
    """Scalar, per-row and tiny extents, and the layered (L, ...) stack —
    the cases of test_pallas_attention.py extent / layered tests."""
    rng = np.random.default_rng(7)
    L, B, S, H, Hkv, D = 3, 2, 128, 8, 4, 16
    q, _, _ = make_qkv(rng, B, 1, S, H, Hkv, D)
    kt = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    vt = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    valid = np.zeros((B, S), bool)
    valid[0, :40] = True
    valid[1, 5:70] = True
    scale = D ** -0.5
    jq, jv = jnp.asarray(q), jnp.asarray(valid)
    for extent in (70, 96, 128, [40, 70]):
        for lay in (0, 2):
            ref = np.asarray(jpa.flash_decode_hs(
                jq, jnp.asarray(kt), jnp.asarray(vt), jv, scale, block_k=32,
                interpret=True, extent=jnp.asarray(extent, jnp.int32),
                layer=jnp.int32(lay)))
            ext = (torch.tensor(extent, dtype=torch.int32)
                   if isinstance(extent, list) else extent)
            out = fa.flash_decode_hs(T_(q), T_(kt), T_(vt), T_(valid), scale,
                                     extent=ext, layer=lay).numpy()
            np.testing.assert_allclose(out, ref, atol=2e-5)
    valid2 = np.zeros((B, S), bool)
    valid2[:, :7] = True
    ref = np.asarray(jpa.flash_decode_hs(
        jq, jnp.asarray(kt[1]), jnp.asarray(vt[1]), jnp.asarray(valid2),
        scale, block_k=32, interpret=True, extent=jnp.int32(7)))
    out = fa.flash_decode_hs(T_(q), T_(kt[1]), T_(vt[1]), T_(valid2), scale,
                             extent=7).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


SPLIT_S = 200        # 4 tiles of 64: chunk boundaries at 64, 128, 192


@pytest.mark.parametrize("n_split", [1, 2, 3, -(-SPLIT_S // 64)])
def test_decode_split_plain_matches_jax_kernel(n_split):
    """The split-K arithmetic of the decode kernel (per-chunk m, l, acc and
    the kernel's merge) against the Pallas kernel in interpret mode: extents
    on and off chunk boundaries, a per-row extent with one row at 1, a chunk
    inside the extent with no valid key (row 1's keys start at 130), and a
    layer view of the (L, ...) stack."""
    rng = np.random.default_rng(17)
    L, B, S, H, Hkv, D = 3, 2, SPLIT_S, 8, 4, 16
    q, _, _ = make_qkv(rng, B, 1, S, H, Hkv, D)
    kt = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    vt = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    base = np.zeros((B, S), bool)
    base[0, :170] = True
    base[1, 130:180] = True
    scale = D ** -0.5
    pos = np.arange(S)
    for extent in (None, 200, 192, 128, 150, [150, 1], [64, 190]):
        ext = np.full(B, S) if extent is None else np.broadcast_to(extent, B)
        valid = base & (pos[None, :] < ext[:, None])   # none past the extent
        if extent == [150, 1]:
            valid[1, 0] = True
        for lay in (0, 2):
            kw = {} if extent is None else dict(
                extent=jnp.asarray(extent, jnp.int32))
            ref = np.asarray(jpa.flash_decode_hs(
                jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt),
                jnp.asarray(valid), scale, block_k=40, interpret=True,
                layer=jnp.int32(lay), **kw))
            pext = (torch.tensor(extent, dtype=torch.int32)
                    if isinstance(extent, list) else extent)
            out = fa.flash_decode_hs_split_plain(
                T_(q), T_(kt), T_(vt), T_(valid), scale, extent=pext,
                layer=lay, n_split=n_split).numpy()
            # a row with no valid key: unspecified in the TPU kernel, 0 here
            live = valid.any(axis=1)
            np.testing.assert_allclose(out[live], ref[live], atol=2e-5)
            np.testing.assert_array_equal(out[~live], 0.0)


@pytest.mark.parametrize("B,Hkv,S,sm", [
    (2, 8, 633, 132),      # the main path: 10 chunks x 16 = 160 blocks
    (8, 8, 633, 132),      # batch 8
    (2, 8, 4096, 132),
    (1, 8, 1557, 132),     # the long form's capacity
    (1, 1, 1, 132),        # one slot
    (3, 2, 70, 132),       # fewer tiles than the card needs
    (64, 8, 300, 132),     # more (row, kv-head) pairs than SMs
    (3, 8, 761, 132),      # the voice-cloning run: one tile a chunk
    (1, 8, 4096, 132),     # 64 tiles: at most DECODE_MAX_SPLIT partials
    (8, 8, 1557, 132),     # batch 8, the long form's capacity
])
def test_decode_split_plan(B, Hkv, S, sm):
    import inspect
    # a function of the shapes only: the extent never reaches the host
    assert list(inspect.signature(fa.decode_split_plan).parameters) == [
        "B", "Hkv", "S", "sm_count"]
    n_split, chunk = fa.decode_split_plan(B, Hkv, S, sm)
    tiles = -(-S // 64)
    assert chunk % 64 == 0 and chunk > 0
    assert n_split * chunk >= S
    assert (n_split - 1) * chunk < S             # no chunk past the capacity
    assert n_split == 1 or B * Hkv < sm          # sm ticket counters suffice
    if tiles * B * Hkv >= sm:
        assert B * Hkv * n_split >= sm
    else:
        assert n_split == tiles                  # one tile per chunk
    assert n_split <= fa.DECODE_MAX_SPLIT
    if n_split > 1 and tiles <= fa.DECODE_MAX_SPLIT:
        assert chunk == 64                       # one tile a chunk
    want = {(2, 8, 633, 132): (10, 64), (3, 8, 761, 132): (12, 64),
            (8, 8, 633, 132): (10, 64), (1, 8, 4096, 132): (32, 128),
            (1, 8, 1557, 132): (25, 64)}
    if (B, Hkv, S, sm) in want:
        assert (n_split, chunk) == want[(B, Hkv, S, sm)]


def test_prefill_bf16_p_plain_matches_jax_kernel_bf16():
    """The bf16-P plain variant (P rounded to bf16 before P.V, the fp32 P
    summed into l — what the wgmma kernel computes) against the Pallas
    prefill kernel run in bf16 in interpret mode. Tolerance 1e-2 + 2^-8 *
    |ref|, the card's bf16 tolerance: the Pallas output is rounded to bf16
    (half an ulp, 2^-9 relative), and the two round P at different points
    (the Pallas kernel relative to its running max over 32-key blocks, the
    plain variant relative to the row's final max), each within 2^-9 of
    p."""
    rng = np.random.default_rng(23)
    B, T, H, Hkv, D = 2, 96, 4, 2, 64
    q, k, v = make_qkv(rng, B, T, T, H, Hkv, D)
    valid = np.ones((B, T), bool)
    valid[1, :20] = False
    bq, bk, bv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jb = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    scale = D ** -0.5
    ref = np.asarray(jpa.flash_prefill(
        jb(bq), jb(bk), jb(bv), jnp.asarray(valid), scale, block_q=32,
        block_k=32, interpret=True).astype(jnp.float32))
    out = fa.flash_prefill_plain(bq, bk, bv, T_(valid), scale,
                                 out_dtype=torch.float32,
                                 p_dtype=torch.bfloat16).numpy()
    for o, r in ((out[0], ref[0]), (out[1, 20:], ref[1, 20:])):
        assert (np.abs(o - r) - 2.0 ** -8 * np.abs(r)).max() <= 1e-2
    np.testing.assert_array_equal(out[1, :20], 0.0)


def p_rounding_inputs(rng, B, T, H, Hkv, D):
    """q, k, v, exact in bf16 (for scale 1), on which rounding P to bf16
    before P.V decides the output: scores are the row max (even keys) or
    2^-10 below it (odd keys), so bf16 rounds every e^(s - m) to 1; v is +c
    on even keys and -c on odd keys, |c| in [32, 64). Odd rows are then
    exactly 0 with bf16 P and c (1 - e^(-2^-10)) / (1 + e^(-2^-10)), at
    least 0.0156, with fp32 P."""
    q = np.zeros((B, T, H, D), np.float32)
    q[..., 0], q[..., 1] = 1.0, 2.0 ** -10
    k = np.zeros((B, T, Hkv, D), np.float32)
    k[..., 0] = 1.0
    k[:, 1::2, :, 1] = -1.0
    c = rng.uniform(32, 64, (B, 1, Hkv, D)) * rng.choice([-1, 1],
                                                         (B, 1, Hkv, D))
    c = torch.from_numpy(c).to(torch.bfloat16).float().numpy()
    sign = np.where(np.arange(T) % 2 == 0, 1.0, -1.0)[None, :, None, None]
    return q, k, (c * sign).astype(np.float32)


def test_prefill_bf16_p_rounding_matches_jax_kernel_bf16():
    """Where rounding P to bf16 moves the output (odd rows by >= 0.0156),
    the bf16-P plain variant agrees with the Pallas prefill kernel run in
    bf16 in interpret mode within 1e-3 + 2^-8 |ref| (the Pallas output's
    bf16 rounding, half an ulp, is inside the relative term; 1e-3 is far
    below the 0.0156 the rounding makes), and the fp32-P plain version
    misses that tolerance."""
    rng = np.random.default_rng(29)
    B, T, H, Hkv, D = 2, 96, 4, 2, 64
    q, k, v = p_rounding_inputs(rng, B, T, H, Hkv, D)
    valid = np.ones((B, T), bool)
    ref = np.asarray(jpa.flash_prefill(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(valid), 1.0, block_q=32, block_k=32,
        interpret=True).astype(jnp.float32))
    bq, bk, bv = (T_(x).to(torch.bfloat16) for x in (q, k, v))
    excess = {}
    for p_dtype in (torch.bfloat16, None):
        out = fa.flash_prefill_plain(bq, bk, bv, T_(valid), 1.0,
                                     out_dtype=torch.float32,
                                     p_dtype=p_dtype).numpy()
        excess[p_dtype] = (np.abs(out - ref) - 2.0 ** -8 * np.abs(ref)).max()
    assert excess[torch.bfloat16] <= 1e-3 < excess[None]
    np.testing.assert_array_equal(ref[:, 1::2], 0.0)


def decode_p_rounding_inputs(rng, B, S, H, Hkv, D):
    """Decode inputs (for scale 1) on which rounding P before P.V decides
    the output, as ``p_rounding_inputs``: scores are the row max (even
    keys) or 2^-10 below it (odd keys); v is +c on even keys and -c on odd
    ones, c in [32, 64). Returned as a bf16 cache (q, kt, vt) and as an int8
    one (kq = kt, ks = 1; vq = 2 vt, vs = 1/2: powers of two, so the scales
    blur nothing and p * vs rounds as p does). With as many valid even
    keys as odd, every row is exactly 0 with bf16 P and c (1 - e^(-2^-10))
    / (1 + e^(-2^-10)) ~ c 2^-11, at least 0.0156, with fp32 P."""
    q = np.zeros((B, 1, H, D), np.float32)
    q[..., 0], q[..., 1] = 1.0, 2.0 ** -10
    kt = np.zeros((B, Hkv, S, D), np.float32)
    kt[..., 0] = 1.0
    kt[:, :, 1::2, 1] = -1.0
    c = rng.integers(64, 128, (B, Hkv, 1, D)) * rng.choice([-1, 1],
                                                          (B, Hkv, 1, D))
    sign = np.where(np.arange(S) % 2 == 0, 1, -1)[None, None, :, None]
    vq = (c * sign).astype(np.int8)
    ones = np.ones((B, Hkv, S), np.float32)
    return {"hs": (q, kt, vq.astype(np.float32) / 2),
            "int8": (q, kt.astype(np.int8), ones, vq, ones / 2)}


def _decode_kernels(kind, args, valid, scale, p_dtype):
    """(the Pallas kernel in interpret mode at args' dtypes, the port's
    plain version with ``p_dtype``) of the B2 ("hs") or B3 ("int8")
    decode, both fp32 out."""
    if kind == "hs":
        q, kt, vt = args
        bq, bk, bv = (T_(x).to(torch.bfloat16) for x in (q, kt, vt))
        ref = jpa.flash_decode_hs(*(jnp.asarray(x, jnp.bfloat16)
                                    for x in (q, kt, vt)),
                                  jnp.asarray(valid), scale, block_k=32,
                                  interpret=True)
        out = fa.flash_decode_hs_plain(bq, bk, bv, T_(valid), scale,
                                       out_dtype=torch.float32,
                                       p_dtype=p_dtype)
    else:
        q, kq, ks, vq, vs = args
        ref = jpa.flash_decode_int8_hs(
            jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(x) for x in
                                            (kq, ks, vq, vs)),
            jnp.asarray(valid), scale, block_k=32, interpret=True)
        out = fa.flash_decode_int8_hs_plain(
            T_(q).to(torch.bfloat16), T_(kq), T_(ks), T_(vq), T_(vs),
            T_(valid), scale, out_dtype=torch.float32, p_dtype=p_dtype)
    return np.asarray(ref.astype(jnp.float32)), out.numpy()


@pytest.mark.parametrize("kind", ["hs", "int8"])
def test_decode_bf16_p_plain_matches_jax_kernel_bf16(kind):
    """The bf16-P decode plain versions (P, or p * vs over the int8 cache,
    rounded to bf16 before P.V; the fp32 P summed into l) against the
    Pallas decode kernels run in bf16 in interpret mode, on random inputs,
    within 1e-2 + 2^-8 |ref|: the Pallas output is rounded to bf16 (half an
    ulp, 2^-9 relative), and the two round P against different maxima (the
    Pallas kernel its running max over 32-key blocks, the plain version the
    row's), each within 2^-9 of p."""
    rng = np.random.default_rng(41)
    B, S, H, Hkv, D = 2, 96, 4, 2, 64
    q, k, v = make_qkv(rng, B, 1, S, H, Hkv, D)
    kt, vt = np.moveaxis(k, 2, 1).copy(), np.moveaxis(v, 2, 1).copy()
    valid = np.ones((B, S), bool)
    valid[1, :20] = False
    if kind == "hs":
        args = (q, kt, vt)
    else:
        kq, ks = (np.array(a) for a in jpa.quantize_kv(jnp.asarray(kt)))
        vq, vs = (np.array(a) for a in jpa.quantize_kv(jnp.asarray(vt)))
        args = (q, kq, ks, vq, vs)
    ref, out = _decode_kernels(kind, args, valid, D ** -0.5, torch.bfloat16)
    assert (np.abs(out - ref) - 2.0 ** -8 * np.abs(ref)).max() <= 1e-2


@pytest.mark.parametrize("kind", ["hs", "int8"])
def test_decode_bf16_p_rounding_matches_jax_kernel_bf16(kind):
    """Where rounding P (p * vs over the int8 cache) to bf16 moves the
    output (every row by >= 0.0156), the bf16-P decode plain versions agree
    with the Pallas decode kernels run in bf16 within 1e-3 + 2^-8 |ref|, and
    the fp32-P ones miss that tolerance."""
    rng = np.random.default_rng(43)
    B, S, H, Hkv, D = 2, 128, 4, 2, 64
    args = decode_p_rounding_inputs(rng, B, S, H, Hkv, D)[kind]
    valid = np.ones((B, S), bool)
    valid[1, :6] = False                   # as many even keys as odd left
    excess = {}
    for p_dtype in (torch.bfloat16, None):
        ref, out = _decode_kernels(kind, args, valid, 1.0, p_dtype)
        excess[p_dtype] = (np.abs(out - ref) - 2.0 ** -8 * np.abs(ref)).max()
    assert excess[torch.bfloat16] <= 1e-3 < excess[None]
    np.testing.assert_array_equal(ref, 0.0)


@pytest.mark.parametrize("kind", ["prefill", "hs", "int8"])
def test_cpu_wrappers_round_p_to_bf16(kind):
    """On the CPU a bf16 call of each wrapper runs its plain version with
    P rounded to bf16 (what the card's kernel and the TPU kernel compute),
    and an fp32 call the fp32-P version."""
    rng = np.random.default_rng(47)
    B, S, H, Hkv, D = 2, 128, 4, 2, 64
    q, kt, vt = decode_p_rounding_inputs(rng, B, S, H, Hkv, D)["hs"]
    _, kq, ks, vq, vs = decode_p_rounding_inputs(rng, B, S, H, Hkv, D)["int8"]
    valid = T_(np.ones((B, S), bool))
    for dt in (torch.bfloat16, torch.float32):
        tq, tk, tv = (T_(x).to(dt) for x in (q, kt, vt))
        if kind == "prefill":
            qp = tq.expand(B, S, H, D)
            kp, vp = tk.transpose(1, 2), tv.transpose(1, 2)
            out = fa.flash_prefill(qp, kp, vp, valid, 1.0)
            ref = fa.flash_prefill_plain(qp, kp, vp, valid, 1.0, p_dtype=dt)
        elif kind == "hs":
            out = fa.flash_decode_hs(tq, tk, tv, valid, 1.0)
            ref = fa.flash_decode_hs_plain(tq, tk, tv, valid, 1.0,
                                           p_dtype=dt)
        else:
            i8 = (T_(kq), T_(ks), T_(vq), T_(vs))
            out = fa.flash_decode_int8_hs(tq, *i8, valid, 1.0)
            ref = fa.flash_decode_int8_hs_plain(tq, *i8, valid, 1.0,
                                                p_dtype=dt)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        if kind != "prefill":              # every decode row: 0 with bf16 P
            assert bool((out == 0).all()) == (dt == torch.bfloat16)


def test_decode_wrapper_split_on_cpu_runs_split_plain():
    """On a CPU tensor, flash_decode_hs with a split runs the plain split
    arithmetic at that split."""
    rng = np.random.default_rng(31)
    q, k, v = make_qkv(rng, 2, 1, 150, 8, 4, 16)
    kt, vt = np.moveaxis(k, 2, 1).copy(), np.moveaxis(v, 2, 1).copy()
    valid = np.ones((2, 150), bool)
    valid[1, :70] = False
    args = (T_(q), T_(kt), T_(vt), T_(valid), 0.25)
    for n_split, chunk in ((1, 192), (2, 128), (3, 64)):
        out = fa.flash_decode_hs(*args, extent=140, split=(n_split, chunk))
        ref = fa.flash_decode_hs_split_plain(*args, extent=140,
                                             n_split=n_split, chunk=chunk)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        np.testing.assert_allclose(out.numpy(), fa.flash_decode_hs(
            *args, extent=140).numpy(), atol=2e-6)


def test_decode_row_without_valid_key_is_zero():
    rng = np.random.default_rng(11)
    q, k, v = make_qkv(rng, 2, 1, 30, 4, 2, 16)
    kt, vt = np.moveaxis(k, 2, 1).copy(), np.moveaxis(v, 2, 1).copy()
    valid = np.zeros((2, 30), bool)
    valid[1, 3:20] = True
    out = fa.flash_decode_hs(T_(q), T_(kt), T_(vt), T_(valid), 0.25,
                             extent=20).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[0], 0.0)


def test_plain_gqa_attention_matches_jax():
    """ops/attention.py: causal_mask (scalar and per-row cache_pos),
    gqa_attention and the head-major gqa_attention_hs, fp32."""
    from moss_ttsd_tpu.ops import attention as jatt
    from moss_ttsd_torch.ops import attention as patt
    rng = np.random.default_rng(13)
    B, T, S, H, Hkv, D = 2, 5, 12, 8, 2, 16
    q, k, v = make_qkv(rng, B, T, S, H, Hkv, D)
    valid = rng.random((B, S)) < 0.8
    valid[:, 0] = True
    for pos in (3, np.array([2, 7])):
        jm = np.asarray(jatt.causal_mask(jnp.asarray(pos), T, S,
                                         jnp.asarray(valid)))
        pm = patt.causal_mask(torch.as_tensor(pos), T, S, T_(valid))
        np.testing.assert_array_equal(pm.numpy(), jm)
    m = patt.causal_mask(7, T, S, T_(valid))
    ref = np.asarray(jatt.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(m.numpy()),
                                        D ** -0.5))
    out = patt.gqa_attention(T_(q), T_(k), T_(v), m, D ** -0.5).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6)
    kt, vt = np.moveaxis(k, 2, 1).copy(), np.moveaxis(v, 2, 1).copy()
    ref = np.asarray(jatt.gqa_attention_hs(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt),
        jnp.asarray(m.numpy()), D ** -0.5))
    out = patt.gqa_attention_hs(T_(q), T_(kt), T_(vt), m, D ** -0.5).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_cpu_wrappers_do_not_count_launches():
    fa.reset_launch_counts()
    q = torch.zeros(1, 3, 4, 16)
    k = torch.zeros(1, 3, 2, 16)
    valid = torch.ones(1, 3, dtype=torch.bool)
    fa.flash_prefill(q, k, k, valid, 0.25)
    kt = torch.zeros(1, 2, 3, 16)
    fa.flash_decode_hs(q[:, :1], kt, kt, valid, 0.25)
    kq, ks = torch.zeros(1, 2, 3, 16, dtype=torch.int8), torch.ones(1, 2, 3)
    fa.flash_decode_int8_hs(q[:, :1], kq, ks, kq, ks, valid, 0.25)
    assert fa.launch_counts() == {"flash_prefill": 0, "flash_decode_hs": 0,
                                  "flash_decode_int8_hs": 0}


def test_build_root_is_set_before_the_first_build(tmp_path, monkeypatch):
    """``set_build_root`` (the server's --jax_cache_dir): a directory, ""
    for a fresh temporary one, None for the default in the checkout; once
    kernels are loaded another root raises (checked without building: the
    loaded-library table is stubbed)."""
    try:
        want = (tmp_path / "k").resolve()
        assert fa.set_build_root(str(tmp_path / "k")) == want
        assert fa.build_root() == want and not want.exists()
        fresh = fa.set_build_root("")
        assert fresh.is_dir() and not any(fresh.iterdir())
        assert fresh != fa.set_build_root("")
        fresh.rmdir()
        fa.build_root().rmdir()
        assert fa.set_build_root(None) == fa.BUILD_ROOT
        monkeypatch.setattr(fa, "_libs", {"flash_prefill": object()})
        with pytest.raises(RuntimeError, match="already loaded"):
            fa.set_build_root(str(tmp_path))
        assert fa.set_build_root(None) == fa.BUILD_ROOT
    finally:
        monkeypatch.undo()
        fa.set_build_root(None)
