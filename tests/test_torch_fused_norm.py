"""The decoder blocks' fused glue (``ops/fused_norm.py``): on the CPU, its
plain versions against the chains of ops the blocks ran before (bit for
bit), cached ``Qwen3Block`` / ``AFMoEBlock`` forwards against the blocks'
earlier arithmetic (bit for bit), and the choice of path; on the card
(``cuda`` marker), the kernels (``csrc/fused_norm.cu``) against the plain
versions at the benchmark cells' shapes, in bf16 and fp32, and under a CUDA
graph. Imports no JAX. On the card:

    python -m pytest tests/test_torch_fused_norm.py -q -m cuda --noconftest
"""
import copy
import math

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.models import lm  # noqa: E402
from moss_ttsd_torch.ops import flash_attention as fa  # noqa: E402
from moss_ttsd_torch.ops import fused_norm as fn  # noqa: E402
from moss_ttsd_torch.ops.rope import apply_rope, rope_cos_sin  # noqa: E402

EPS = 1e-6
DTYPES = ["bfloat16", "float32"]
# residual_rms_norm's forms: (an addend, its norm, the output's norm)
FORMS = {"norm": (False, False, True), "add_norm": (True, False, True),
         "sandwich": (True, True, True), "add_normed": (True, True, False)}


def _chain_rms(x, w, eps):
    """The RMSNorm the blocks ran before the kernels, op by op."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _rand(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def _weight(gen, n, dtype):
    return (1.0 + 0.2 * torch.randn(n, generator=gen, device=gen.device)
            ).to(dtype)


def _row_inputs(gen, shape, dtype, form):
    has_y, has_wy, has_w = FORMS[form]
    N = shape[-1]
    return (_rand(gen, shape, dtype),
            _rand(gen, shape, dtype, 0.5) if has_y else None,
            _weight(gen, N, dtype) if has_w else None,
            _weight(gen, N, dtype) if has_wy else None)


def _qk_inputs(gen, B, T, H, Hkv, D, dtype):
    q = _rand(gen, (B, T, H, D), dtype, 3.0)
    k = _rand(gen, (B, T, Hkv, D), dtype, 3.0)
    pos = torch.randint(0, 4096, (B, T), generator=gen, device=gen.device)
    cos, sin = rope_cos_sin(pos, D, 1_000_000.0)
    return q, k, _weight(gen, D, dtype), _weight(gen, D, dtype), cos, sin


# -- the CPU: the plain versions and the blocks ---------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_residual_rms_norm_equals_the_chain(dtype, form):
    """``residual_rms_norm_plain`` (the CPU's path) is the add and
    ``rms_norm_fn`` chain the blocks ran, bit for bit, in each form; the
    wrapper takes it on the CPU."""
    gen = torch.Generator().manual_seed(len(form))
    x, y, w, w_y = _row_inputs(gen, (3, 5, 64), getattr(torch, dtype), form)
    xo = x if y is None else x + (y if w_y is None
                                  else _chain_rms(y, w_y, EPS))
    for f in (fn.residual_rms_norm_plain, fn.residual_rms_norm):
        got_x, got_h = f(x, y, w, EPS, w_y=w_y)
        assert torch.equal(got_x, xo)
        assert (got_h is None) == (w is None)
        if w is not None:
            assert torch.equal(got_h, _chain_rms(xo, w, EPS))
    # the bench-only ablate_norms stub: every RMSNorm is x * w
    ab_x = x if y is None else x + (y if w_y is None else y * w_y)
    got_x, got_h = fn.residual_rms_norm_plain(x, y, w, EPS, w_y=w_y,
                                              ablate=True)
    assert torch.equal(got_x, ab_x)
    assert got_h is None if w is None else torch.equal(got_h, ab_x * w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rope", [True, False])
def test_plain_qk_norm_rope_equals_the_chain(dtype, rope):
    """``qk_norm_rope_plain`` is the per-head ``rms_norm_fn`` of q and k and
    then ``apply_rope`` on each, bit for bit; the wrapper takes it on the
    CPU."""
    gen = torch.Generator().manual_seed(7)
    q, k, wq, wk, cos, sin = _qk_inputs(gen, 2, 3, 4, 2, 16,
                                        getattr(torch, dtype))
    want_q, want_k = _chain_rms(q, wq, EPS), _chain_rms(k, wk, EPS)
    if rope:
        want_q, want_k = (apply_rope(want_q, cos, sin),
                          apply_rope(want_k, cos, sin))
    for f in (fn.qk_norm_rope_plain, fn.qk_norm_rope):
        got_q, got_k = f(q, k, wq, wk, EPS, cos, sin, rope=rope)
        assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_silu_mul_equals_the_chain(dtype):
    gen = torch.Generator().manual_seed(3)
    g, u = (_rand(gen, (2, 3, 48), getattr(torch, dtype)) for _ in "gu")
    assert torch.equal(fn.silu_mul_plain(g, u), F.silu(g) * u)
    assert torch.equal(fn.silu_mul(g, u), F.silu(g) * u)


def _earlier_qwen3(blk, x, cos, sin, li, cache, pos, kv):
    """``Qwen3Block.forward``'s cached arithmetic before the fused glue."""
    c = blk.cfg
    H, Hkv, D = blk.heads, blk.kv_heads, c.head_dim
    B, T, _ = x.shape
    h = _chain_rms(x, blk.input_ln.weight, c.rms_norm_eps)
    q, k, v = blk._projs(("q_proj", "k_proj", "v_proj"), h, None)
    q = _chain_rms(q.reshape(B, T, H, D), blk.q_norm.weight, c.rms_norm_eps)
    k = _chain_rms(k.reshape(B, T, Hkv, D), blk.k_norm.weight,
                   c.rms_norm_eps)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attn = lm.attend_cached(q, k, v.reshape(B, T, Hkv, D), cache, li, pos,
                            kv)
    x = x + blk._proj("o_proj", attn.reshape(B, T, H * D), None)
    h = _chain_rms(x, blk.post_ln.weight, c.rms_norm_eps)
    gate, up = blk._projs(("gate_proj", "up_proj"), h, None)
    return x + blk._proj("down_proj", F.silu(gate) * up, None)


def _earlier_afmoe(blk, x, cos, sin, li, cache, pos, kv):
    """``AFMoEBlock.forward``'s arithmetic before the fused glue."""
    c, eps = blk.cfg, blk.cfg.rms_norm_eps
    H, Hkv, D = blk.heads, blk.kv_heads, c.head_dim
    B, T, _ = x.shape
    h = _chain_rms(x, blk.input_ln.weight, eps)
    q = _chain_rms(blk.q_proj(h).reshape(B, T, H, D), blk.q_norm.weight, eps)
    k = _chain_rms(blk.k_proj(h).reshape(B, T, Hkv, D), blk.k_norm.weight,
                   eps)
    v = blk.v_proj(h).reshape(B, T, Hkv, D)
    if blk.window:
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attn = lm.attend_cached(q, k, v, cache, li, pos, kv, window=blk.window)
    gated = attn.reshape(B, T, H * D) * torch.sigmoid(blk.g_proj(h))
    x = x + _chain_rms(blk.o_proj(gated), blk.post_attn_ln.weight, eps)
    h = _chain_rms(x, blk.pre_mlp_ln.weight, eps)
    mlp = blk.mlp
    if isinstance(mlp, lm.SwiGLU):
        y = mlp.down_proj(F.silu(mlp.gate_proj(h)) * mlp.up_proj(h))
    else:
        y = mlp(h)                  # the shared expert: the same SwiGLU
    return x + _chain_rms(y, blk.post_mlp_ln.weight, eps)


def _afmoe_cfg(dtype):
    period = ("sliding_attention",) * 3 + ("full_attention",)
    return LMConfig().tiny(
        block_type="afmoe", num_hidden_layers=4, layer_types=period,
        sliding_window=4, num_dense_layers=1, num_experts=4,
        router_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
        num_shared_experts=1, route_scale=2.826, route_norm=True,
        mup_enabled=True, tie_word_embeddings=False, rms_norm_eps=1e-5,
        rope_theta=10000.0, dtype=dtype, param_dtype=dtype,
        speech_token_range=(0, 160))


def _random_norm_weights(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight") or name.endswith("ln.weight"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=gen))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [6, 1])
@pytest.mark.parametrize("block", ["qwen3", "afmoe"])
def test_cached_block_forward_keeps_the_earlier_arithmetic(block, T, dtype):
    """Each layer's cached forward through the fused glue (a prefill of 6
    tokens at slot 0, a decode token at slot 6) gives the blocks' earlier
    chains' hidden states and cache bit for bit on the CPU, in every layer
    of both blocks (the AFMoE one's window and full, dense and expert
    layers), with norm weights that are not 1."""
    cfg = (LMConfig(dtype=dtype, param_dtype=dtype).tiny() if block == "qwen3"
           else _afmoe_cfg(dtype))
    model = lm.AsteroidLM.init_random(cfg, seed=2, device="cpu")
    _random_norm_weights(model, 5)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(T)
    B, S = 2, 8
    pos0 = 0 if T > 1 else 6
    x = (torch.randn((B, T, cfg.hidden_size), generator=gen)).to(dt)
    cos, sin = rope_cos_sin(torch.arange(pos0, pos0 + T).expand(B, T),
                            cfg.head_dim, cfg.rope_theta)
    kv = torch.ones((B, S), dtype=torch.bool)
    cache = lm.init_cache(cfg, B, S, dtype=dt, device="cpu")
    for name in cache:
        cache[name].normal_(generator=gen)
    earlier = _earlier_qwen3 if block == "qwen3" else _earlier_afmoe
    for li, blk in enumerate(model.layers):
        c1, c2 = cache, copy.deepcopy(cache)
        got = blk(x, cos, sin, li, c1, pos0, kv)
        want = earlier(blk, x, cos, sin, li, c2, pos0, kv)
        assert torch.equal(got, want)
        assert all(torch.equal(c1[n], c2[n]) for n in cache)
        x = got


def _refuse_fused(monkeypatch, what):
    def refuse(*a, **k):
        raise AssertionError(f"{what} entered a fused wrapper")
    for name in ("residual_rms_norm", "qk_norm_rope", "silu_mul"):
        monkeypatch.setattr(lm, name, refuse)


def test_the_cache_free_forward_runs_the_plain_glue(monkeypatch):
    """The cache-free forward (training: autograd runs through it) takes
    the plain versions; a cached forward the fused wrappers."""
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny()
    assert lm.block_glue(None, cfg) == (fn.residual_rms_norm_plain,
                                        fn.qk_norm_rope_plain,
                                        fn.silu_mul_plain)
    assert lm.block_glue({}, cfg) == (fn.residual_rms_norm, fn.qk_norm_rope,
                                      fn.silu_mul)
    _refuse_fused(monkeypatch, "the cache-free forward")
    model = lm.AsteroidLM.init_random(cfg, seed=0, device="cpu")
    ids = torch.zeros((2, 5, cfg.channels), dtype=torch.int64)
    t, s = model(ids)
    assert bool(torch.isfinite(t).all() and torch.isfinite(s).all())


@pytest.mark.parametrize("block", ["qwen3", "afmoe"])
@pytest.mark.parametrize("stub", ["ablate_norms", "ablate_rope"])
def test_the_ablate_stubs_run_the_plain_glue(monkeypatch, stub, block):
    """Under a bench-only stub a cached forward of either block takes the
    plain versions, ``ablate_norms`` bound to them (every RMSNorm x * w),
    and gives what the plain chains with the stub give."""
    base = (LMConfig(dtype="float32", param_dtype="float32").tiny()
            if block == "qwen3" else _afmoe_cfg("float32"))
    cfg = LMConfig.from_dict({**base.to_dict(), stub: True})
    res, qk, glu = lm.block_glue({}, cfg)
    assert glu is fn.silu_mul_plain
    if stub == "ablate_rope":
        assert (res, qk) == (fn.residual_rms_norm_plain, fn.qk_norm_rope_plain)
    else:
        for f, plain in ((res, fn.residual_rms_norm_plain),
                         (qk, fn.qk_norm_rope_plain)):
            assert f.func is plain and f.keywords == {"ablate": True}
    _refuse_fused(monkeypatch, "a stubbed forward")
    model = lm.AsteroidLM.init_random(cfg, seed=0, device="cpu")
    _random_norm_weights(model, 3)
    gen = torch.Generator().manual_seed(1)
    B, T = 2, 5
    x = torch.randn((B, T, cfg.hidden_size), generator=gen)
    cos, sin = rope_cos_sin(torch.arange(T).expand(B, T), cfg.head_dim,
                            cfg.rope_theta)
    kv = torch.ones((B, 8), dtype=torch.bool)
    cache = lm.init_cache(cfg, B, 8, dtype=torch.float32, device="cpu")
    blk = model.layers[0]
    got = blk(x, cos, sin, 0, cache, 0, kv)
    ab = stub == "ablate_norms"

    def norm(v, w):
        return v * w if ab else _chain_rms(v, w, cfg.rms_norm_eps)
    h = norm(x, blk.input_ln.weight)
    if block == "qwen3":
        q, k, v = blk._projs(("q_proj", "k_proj", "v_proj"), h, None)
    else:
        q, k, v = blk.q_proj(h), blk.k_proj(h), blk.v_proj(h)
    H, Hkv, D = blk.heads, blk.kv_heads, cfg.head_dim
    q = norm(q.reshape(B, T, H, D), blk.q_norm.weight)
    k = norm(k.reshape(B, T, Hkv, D), blk.k_norm.weight)
    if stub != "ablate_rope" and (block == "qwen3" or blk.window):
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    ref_cache = lm.init_cache(cfg, B, 8, dtype=torch.float32, device="cpu")
    attn = lm.attend_cached(q, k, v.reshape(B, T, Hkv, D), ref_cache, 0, 0,
                            kv, window=getattr(blk, "window", 0))
    if block == "qwen3":
        x = x + blk._proj("o_proj", attn.reshape(B, T, H * D), None)
        gate, up = blk._projs(("gate_proj", "up_proj"), norm(
            x, blk.post_ln.weight), None)
        want = x + blk._proj("down_proj", F.silu(gate) * up, None)
    else:
        gated = attn.reshape(B, T, H * D) * torch.sigmoid(blk.g_proj(h))
        x = x + norm(blk.o_proj(gated), blk.post_attn_ln.weight)
        h = norm(x, blk.pre_mlp_ln.weight)
        mlp = blk.mlp
        y = mlp.down_proj(F.silu(mlp.gate_proj(h)) * mlp.up_proj(h))
        want = x + norm(y, blk.post_mlp_ln.weight)
    assert torch.equal(got, want)


@pytest.mark.parametrize("block", ["qwen3", "afmoe"])
def test_cpu_never_builds_a_kernel(monkeypatch, block):
    """A cached backbone on the CPU (prefill and decode) never reaches the
    kernels' build, and counts no launch."""
    def refuse(*a, **k):
        raise AssertionError("the CPU built a kernel")
    monkeypatch.setattr(fa, "build_kernels", refuse)
    fa.reset_launch_counts()
    cfg = (LMConfig(dtype="float32", param_dtype="float32").tiny()
           if block == "qwen3" else _afmoe_cfg("float32"))
    model = lm.AsteroidLM.init_random(cfg, seed=0, device="cpu")
    cache = lm.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    kv = torch.ones((2, 8), dtype=torch.bool)
    ids = torch.zeros((2, 5, cfg.channels), dtype=torch.int64)
    h, _ = model.backbone(ids, torch.arange(5).expand(2, 5), kv, cache, 0)
    h1, _ = model.backbone(ids[:, :1], torch.full((2, 1), 5), kv, cache, 5)
    assert bool(torch.isfinite(h).all() and torch.isfinite(h1).all())
    for f in (fn.residual_rms_norm, fn.qk_norm_rope, fn.silu_mul):
        assert f in fa._COUNTED and f.launches == 0


# -- the card -------------------------------------------------------------------

MANT = {torch.bfloat16: 7, torch.float32: 23}
DECODE_ROWS = [(8, 1), (16, 1)]           # the dialogue cells, the AFMoE one
PREFILL_ROWS = [(8, 640), (16, 640)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _ulp(t, dtype):
    """The spacing of ``dtype`` at |t| (float64)."""
    a = t.double().abs().clamp_min(torch.finfo(dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - MANT[dtype])


def _stat(v):
    """The plain version's fp32 statistic rsqrt(mean(v^2) + eps) a row."""
    vf = v.float()
    return torch.rsqrt(torch.mean(vf * vf, dim=-1, keepdim=True) + EPS)


def _norm_bound(v, w, out):
    """What a reordered fp32 sum can move in T(T(v r) w). The two sums of
    squares (each a tree of at most 3 log2 N levels) differ by at most
    6 log2(N) 2^-24 of their value, so r by half of that; then one ulp
    at each rounding point: the normed value's, carried by the weight,
    and the output's."""
    r = _stat(v)
    n = (v.float() * r).to(v.dtype)
    rel = 3 * math.log2(v.shape[-1]) * 2.0 ** -24
    dn = _ulp(n, v.dtype) + (v.double() * r.double()).abs() * rel
    return _ulp(out, out.dtype) + w.double().abs() * dn


def _within(got, want, bound):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    excess = (got.double() - want.double()).abs() - bound
    assert float(excess.max()) <= 0.0, float(excess.max())


def _exact(gen, shape, dtype, top=64):
    """Values k / 16, |k| <= top: every fp32 sum of their squares over a
    row of 2048 is exact in any order, so the statistics are bit-equal."""
    k = torch.randint(-top, top + 1, shape, generator=gen, device=gen.device)
    return (k.float() / 16).to(dtype)


def _rows_bound(x, y, w, w_y, got_x):
    """The bound on x': one ulp of it, plus the addend's norm bound."""
    dx = torch.zeros_like(x, dtype=torch.float64)
    if w_y is not None:
        want_y = fn.rms_norm_fn(y, w_y, EPS)
        dx = _ulp(got_x, x.dtype) + _norm_bound(y, w_y, want_y)
    return dx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", DECODE_ROWS + PREFILL_ROWS)
@pytest.mark.parametrize("form", list(FORMS))
def test_residual_rms_norm_kernel_matches_plain(cuda, form, rows, dtype):
    """Each form at the cells' rows of 2048 (decode 8 and 16, prefill 8 and
    16 x 640): x' bit-equal to the plain add (within one ulp of x' and the
    addend's norm bound where the addend is normed), h within one ulp at
    each of its rounding points."""
    dt = getattr(torch, dtype)
    x, y, w, w_y = _row_inputs(cuda, (*rows, 2048), dt, form)
    got_x, got_h = fn.residual_rms_norm(x, y, w, EPS, w_y=w_y)
    want_x, want_h = fn.residual_rms_norm_plain(x, y, w, EPS, w_y=w_y)
    dx = _rows_bound(x, y, w, w_y, want_x)
    _within(got_x, want_x, dx)
    if w is None:
        assert got_h is None
        return
    r = _stat(want_x).double()
    _within(got_h, want_h, _norm_bound(want_x, w, want_h)
            + w.double().abs() * r * dx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["norm", "add_norm", "sandwich"])
def test_residual_rms_norm_kernel_keeps_the_rounding_points(cuda, form,
                                                            dtype):
    """Where the fp32 sums are exact in any order (``_exact``), the kernel
    equals the plain version bit for bit: only the order of the sums may
    differ. (The sandwich: its x' and the addend's norm; its h sums values
    that are no longer exact.)"""
    dt = getattr(torch, dtype)
    x = _exact(cuda, (16, 640, 2048), dt, 32)
    y = _exact(cuda, x.shape, dt, 32) if form != "norm" else None
    w, w_y = _weight(cuda, 2048, dt), (_weight(cuda, 2048, dt)
                                       if form == "sandwich" else None)
    got = fn.residual_rms_norm(x, y, w, EPS, w_y=w_y)
    want = fn.residual_rms_norm_plain(x, y, w, EPS, w_y=w_y)
    assert torch.equal(got[0], want[0])
    if form != "sandwich":
        assert torch.equal(got[1], want[1])


def _qk_bound(v, w, rope_in, got, cos, sin, rope):
    b = _norm_bound(v, w, rope_in)
    if not rope:
        return b
    half = b.shape[-1] // 2
    rot = torch.cat([b[..., half:], b[..., :half]], dim=-1)
    c, s = cos[:, :, None, :].double(), sin[:, :, None, :].double()
    return _ulp(got, got.dtype) + c.abs() * b + s.abs() * rot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("rows", DECODE_ROWS + PREFILL_ROWS)
@pytest.mark.parametrize("heads", [(16, 8), (32, 4)])
def test_qk_norm_rope_kernel_matches_plain(cuda, heads, rows, rope, dtype):
    """q/k at MOSS-TTSD's 16 / 8 and Trinity-Mini's 32 / 4 heads of 128, at
    the cells' decode and prefill rows, with and without RoPE: within one
    ulp at each rounding point (the normed q or k, carried through the
    rotation, and the output)."""
    dt = getattr(torch, dtype)
    q, k, wq, wk, cos, sin = _qk_inputs(cuda, *rows, *heads, 128, dt)
    got = fn.qk_norm_rope(q, k, wq, wk, EPS, cos, sin, rope=rope)
    want = fn.qk_norm_rope_plain(q, k, wq, wk, EPS, cos, sin, rope=rope)
    for v, w, g, p in zip((q, k), (wq, wk), got, want):
        normed = fn.rms_norm_fn(v, w, EPS)
        assert g.is_contiguous()
        _within(g, p, _qk_bound(v, w, normed, g, cos, sin, rope))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rope", [True, False])
def test_qk_norm_rope_kernel_keeps_the_rounding_points(cuda, rope, dtype):
    """Exact sums (``_exact``): bit-equal to the plain version, RoPE's
    products and sum included."""
    dt = getattr(torch, dtype)
    q, k, wq, wk, cos, sin = _qk_inputs(cuda, 16, 640, 32, 4, 128, dt)
    q, k = _exact(cuda, q.shape, dt), _exact(cuda, k.shape, dt)
    got = fn.qk_norm_rope(q, k, wq, wk, EPS, cos, sin, rope=rope)
    want = fn.qk_norm_rope_plain(q, k, wq, wk, EPS, cos, sin, rope=rope)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64])
def test_qk_norm_rope_kernel_strided_and_small_heads(cuda, D):
    """q and k as strided views (a fused q/k projection's halves), a batch
    of 1's RoPE tables broadcast over 3 rows, and the small head sizes of
    the tiny test models."""
    dt = torch.bfloat16
    B, T, H, Hkv = 3, 5, 4, 2
    qk = _rand(cuda, (B, T, (H + Hkv) * D), dt, 2.0)
    q = qk[..., :H * D].reshape(B, T, H, D)
    k = qk[..., H * D:].reshape(B, T, Hkv, D)
    wq, wk = _weight(cuda, D, dt), _weight(cuda, D, dt)
    cos, sin = rope_cos_sin(torch.arange(T, device="cuda")[None], D, 1e4)
    got = fn.qk_norm_rope(q, k, wq, wk, EPS, cos, sin)
    want = fn.qk_norm_rope_plain(q, k, wq, wk, EPS, cos, sin)
    for v, w, g, p in zip((q, k), (wq, wk), got, want):
        _within(g, p, _qk_bound(v, w, fn.rms_norm_fn(v, w, EPS), g,
                                cos.expand(B, T, D), sin.expand(B, T, D),
                                True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 1, 6144), (16, 1, 1024),
                                   (8, 640, 6144), (3, 1, 44)])
def test_silu_mul_kernel_matches_plain(cuda, shape, dtype):
    """silu(gate) * up at the MLPs' widths (MOSS-TTSD's 6144 at decode and
    prefill, Trinity-Mini's shared expert of 1024) and a tail shorter
    than a vector: within one ulp of the product, plus one of silu's
    rounding carried by up."""
    dt = getattr(torch, dtype)
    g, u = _rand(cuda, shape, dt, 3.0), _rand(cuda, shape, dt)
    got, want = fn.silu_mul(g, u), fn.silu_mul_plain(g, u)
    bound = (_ulp(want, dt)
             + u.double().abs() * _ulp(F.silu(g), dt))
    _within(got, want, bound)


@pytest.mark.cuda
def test_kernels_replay_in_a_cuda_graph(cuda):
    """All three kernels captured in one CUDA graph record one launch each
    (the counters take them at each replay, not at the capture) and,
    replayed over new inputs copied into the captured ones, give what
    eager launches give on those inputs, bit for bit."""
    dt = torch.bfloat16
    x, y, w, w_y = _row_inputs(cuda, (8, 1, 2048), dt, "sandwich")
    q, k, wq, wk, cos, sin = _qk_inputs(cuda, 8, 1, 16, 8, 128, dt)
    g, u = _rand(cuda, (8, 1, 6144), dt), _rand(cuda, (8, 1, 6144), dt)
    ins = (x, y, q, k, cos, sin, g, u)

    def body():
        return (fn.residual_rms_norm(x, y, w, EPS, w_y=w_y)
                + fn.qk_norm_rope(q, k, wq, wk, EPS, cos, sin)
                + (fn.silu_mul(g, u),))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with fa.recording_launches(), torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    fa.reset_launch_counts()
    with fa.recording_launches() as calls, torch.cuda.graph(graph):
        outs = body()
    assert calls == {"residual_rms_norm": 1, "qk_norm_rope": 1,
                     "silu_mul": 1}
    assert fn.residual_rms_norm.launches == 0
    for t in ins:
        t.copy_(torch.randn(t.shape, generator=cuda, device="cuda")
                .to(t.dtype))
    graph.replay()
    fa.add_launch_counts(calls)
    torch.cuda.synchronize()
    for got, want in zip(outs, body()):
        assert torch.equal(got, want)
    assert fn.qk_norm_rope.launches == 2     # the replay's and body()'s


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor launches or raises: an fp16 row, a row not a multiple
    of a 16-byte vector, a misaligned row, an odd head size, an addend of
    another shape."""
    x = _rand(cuda, (4, 64), torch.bfloat16)
    w = _weight(cuda, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="float16"):
        fn.residual_rms_norm(x.half(), None, w.half(), EPS)
    with pytest.raises(ValueError, match="multiple"):
        fn.residual_rms_norm(x[:, :60], None, w[:60], EPS)
    with pytest.raises(ValueError, match="aligned"):
        fn.residual_rms_norm(_rand(cuda, (264,), torch.bfloat16)[4:260]
                             .reshape(4, 64), None, w, EPS)
    with pytest.raises(ValueError, match="y"):
        fn.residual_rms_norm(x, x[:2], w, EPS)
    q = _rand(cuda, (1, 1, 2, 15), torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fn.qk_norm_rope(q, q, w[:15], w[:15], EPS, None, None, rope=False)
    with pytest.raises(ValueError, match="contiguous"):
        fn.silu_mul(x.t(), x.t())
