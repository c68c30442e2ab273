"""The w8a16 product (``ops/w8a16.py``): on the CPU, its plain version
against the arithmetic ``QLinear`` and the int8 heads had before it, and
the choice of path (the CPU never enters a kernel's wrapper); on the card
(``cuda`` marker), the kernels (``csrc/w8a16.cu``) against the plain
version: the decode kernel at every projection shape of MOSS-TTSD v0.5 and
its tensor-parallel halves, at the heads, under a CUDA graph; the
many-row kernel at a prefill's rows; the fp32 kernel; the choice on the
card; an int8 engine's prefill and decode steps. Imports no JAX. On the
card:

    python -m pytest tests/test_torch_w8a16.py -q -m cuda --noconftest
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from moss_ttsd_torch.ops import w8a16 as W  # noqa: E402
from moss_ttsd_torch.ops.quantize import quantize_lm_params  # noqa: E402

# MOSS-TTSD v0.5 (Qwen3-1.7B) projections, (N out, K in)
PROJ = {"q_o": (2048, 2048), "k_v": (1024, 2048), "gate_up": (6144, 2048),
        "down": (2048, 6144)}
# a tensor-parallel half: q/k/v/gate/up split by output rows, o/down by
# their contraction
TP_HALF = {"q_half": (1024, 2048), "k_v_half": (512, 2048),
           "gate_up_half": (3072, 2048), "o_half": (2048, 1024),
           "down_half": (2048, 3072)}
ROWS = (1, 2, 3, 8, 16)


def _weights(gen, N, K):
    """An int8 weight and its fp32 (N, 1) scales on ``gen``'s device,
    quantized as the engine quantizes a projection."""
    w = torch.randn((N, K), generator=gen, device=gen.device) / K ** 0.5
    q = quantize_lm_params({"layers.0.q_proj.weight": w})
    return q["layers.0.q_proj.weight_q"], q["layers.0.q_proj.weight_s"]


def _one(x, q, s, b=None, head=False):
    """The kernel over one weight."""
    return W.w8a16_group(x, [(q, s, b)], head)[0]


def _x(gen, rows, K):
    return torch.randn((rows, K), generator=gen, device=gen.device).to(
        torch.bfloat16)


# -- the CPU: the plain version and the choice ----------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [1, 8, 16, 40])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_equals_the_qlinear_arithmetic(dtype, rows, bias):
    """``w8a16_plain`` and ``QLinear`` compute what ``QLinear.forward``
    computed before the kernel, bit for bit: the weight cast to the compute
    dtype times the scale cast to it, then ``F.linear``, at any number of
    rows (more than 16 is the prefill's path on the card too)."""
    from moss_ttsd_torch.models.lm import QLinear
    gen = torch.Generator().manual_seed(rows)
    dt = getattr(torch, dtype)
    q, s = _weights(gen, 48, 32)
    b = torch.randn(48, generator=gen) if bias else None
    x = torch.randn((2, rows, 32), generator=gen).to(dt)
    want = F.linear(x, q.to(dt) * s.to(dt), None if b is None else b.to(dt))
    assert torch.equal(W.w8a16_plain(x, q, s, b), want)
    lin = QLinear(32, 48, bias=bias)
    with torch.no_grad():
        lin.weight_q.copy_(q)
        lin.weight_s.copy_(s)
        if bias:
            lin.bias.copy_(b)
    assert torch.equal(lin(x), want)
    if bias:
        assert torch.equal(lin(x, add_bias=False),
                           F.linear(x, q.to(dt) * s.to(dt)))


def _int8_model(dtype="bfloat16"):
    import dataclasses
    from moss_ttsd_torch.core.config import LMConfig
    from moss_ttsd_torch.models.lm import AsteroidLM
    cfg = LMConfig(dtype=dtype, param_dtype="float32").tiny()
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    qcfg = dataclasses.replace(cfg, quantized=True)
    qmodel = AsteroidLM(qcfg)
    qmodel.load_state_dict(quantize_lm_params(model.state_dict()))
    return qcfg, qmodel.eval()


@pytest.mark.parametrize("restricted", [False, True])
def test_plain_heads_equal_the_int8_head_arithmetic(restricted):
    """The int8 heads through ``w8a16_product`` on the CPU give what
    ``logits_all`` computed before the kernel, bit for bit: the table
    cast to the compute dtype, an fp32 product, times the fp32 scales."""
    from moss_ttsd_torch.ops.w8a16 import matmul_f32_out
    cfg, m = _int8_model()
    h = torch.randn((3, 1, cfg.hidden_size),
                    generator=torch.Generator().manual_seed(1)).to(
                        torch.bfloat16)
    text, speech = m.logits_all(h, restricted=restricted)
    lo, hi = cfg.text_head_window() if restricted else (0, cfg.vocab_size)
    h2 = h.reshape(-1, cfg.hidden_size)
    Cm1, Vs = cfg.channels - 1, cfg.speech_vocab_size
    want_t = (matmul_f32_out(h2, m.embed_text_q[lo:hi].to(h2.dtype).t())
              * m.embed_text_s[lo:hi, 0].float())
    w = m.embed_speech_q.reshape(Cm1 * Vs, -1).to(h2.dtype)
    want_s = (matmul_f32_out(h2, w.t())
              * m.embed_speech_s.reshape(Cm1 * Vs).float())
    assert torch.equal(text.reshape(-1, hi - lo), want_t)
    assert torch.equal(speech.reshape(-1, Cm1 * Vs), want_s)


def test_cpu_never_enters_the_kernel_wrapper(monkeypatch):
    """On the CPU ``QLinear`` and the int8 heads take the plain version at
    every number of rows: no kernel's wrapper is called."""
    def refuse(*a, **k):
        raise AssertionError("the CPU entered a kernel's wrapper")
    for name in ("w8a16_group", "w8a16_gemm", "w8a16_simt", "_launch"):
        monkeypatch.setattr(W, name, refuse)
    cfg, m = _int8_model()
    ids = torch.zeros((2, 9, cfg.channels), dtype=torch.int64)
    for T in (1, 9):        # a decode step's rows, a prefill's
        pos = torch.arange(T).expand(2, T)
        valid = torch.ones((2, T), dtype=torch.bool)
        h, _ = m.backbone(ids[:, :T], pos, valid, None)
        t, s = m.logits_all(h[:, -1:])
        assert bool(torch.isfinite(t).all() and torch.isfinite(s).all())


@pytest.mark.parametrize("wrapper", ["w8a16_group", "w8a16_gemm",
                                     "w8a16_simt"])
def test_wrapper_refuses_what_the_kernel_does_not_take(wrapper):
    """Each kernel's wrapper raises (before any build) on CPU tensors: it
    launches or it raises, and ``w8a16_product`` sends CPU tensors to the
    plain version at any number of rows."""
    gen = torch.Generator().manual_seed(0)
    q, s = _weights(gen, 32, 64)
    dt = torch.float32 if wrapper == "w8a16_simt" else torch.bfloat16
    x = torch.randn((4, 64), generator=gen).to(dt)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(W, wrapper)(x, [(q, s, None)])
    assert torch.equal(W.w8a16_product(x, q, s), W.w8a16_plain(x, q, s))
    x40 = torch.randn((40, 64), generator=gen).to(dt)
    assert torch.equal(W.w8a16_product(x40, q, s), W.w8a16_plain(x40, q, s))


# -- the card -------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _exact_ref(x, q, s, head):
    """The product of the plain version's weights (bf16(bf16(q) bf16(s))
    for a projection, bf16(q) then x s for a head) in float64, and the
    bound of an fp32 sum of K terms in any order: 2 K 2^-24 sum |terms|
    (twice the recursive-summation bound, for the tensor cores' adds)."""
    xd = x.double()
    if head:
        w = q.to(torch.bfloat16).double()
        sd = s.reshape(-1).double()
        ref = (xd @ w.t()) * sd
        bound = (xd.abs() @ w.abs().t()) * sd
    else:
        w = (q.to(torch.bfloat16) * s.to(torch.bfloat16)).double()
        ref = xd @ w.t()
        bound = xd.abs() @ w.abs().t()
    return ref, 2.0 * x.shape[1] * 2.0 ** -24 * bound


def _check(out, ref, bound, bf16_out):
    """Within the fp32 sum's bound, plus (bf16 out) the one rounding of the
    output, half an ulp: 2^-9 of |ref| (2^-8 kept for the ulp's step)."""
    excess = (out.double() - ref).abs() - bound
    if bf16_out:
        excess = excess - 2.0 ** -8 * ref.abs()
    assert bool(torch.isfinite(out).all())
    assert float(excess.max()) <= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", list(PROJ) + list(TP_HALF))
def test_kernel_matches_plain_at_projection_shapes(cuda, shape, rows):
    """A projection (bf16 out) at each MOSS-TTSD v0.5 shape and its
    tensor-parallel halves, 1-16 rows: within the fp32 sum's bound of the
    plain version's product (``_exact_ref``), and within a bf16 ulp of the
    plain version itself (cuBLAS over the dequantized copy)."""
    N, K = {**PROJ, **TP_HALF}[shape]
    q, s = _weights(cuda, N, K)
    x = _x(cuda, rows, K)
    out = _one(x, q, s)
    assert out.dtype == torch.bfloat16 and out.shape == (rows, N)
    _check(out, *_exact_ref(x, q, s, False), True)
    plain = W.w8a16_plain(x, q, s).float()
    assert float(((out.float() - plain).abs()
                  - 2.0 ** -7 * plain.abs()).max()) <= 1e-3


@pytest.mark.cuda
def test_kernel_projection_bias_and_row_stride(cuda):
    """A bias (added to the fp32 sum, rounded once) and x rows that are a
    strided view (a row of every other one)."""
    N, K = PROJ["k_v"]
    q, s = _weights(cuda, N, K)
    b = torch.randn(N, generator=cuda, device="cuda").to(torch.bfloat16)
    x = _x(cuda, 16, K)[::2]
    out = _one(x, q, s, b)
    ref, bound = _exact_ref(x, q, s, False)
    _check(out, ref + b.double(), bound, True)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("table", ["text", "text_window", "speech"])
def test_kernel_matches_plain_at_the_heads(cuda, table, rows):
    """The tied int8 heads (fp32 out, the scale on the fp32 sum): the whole
    152704-row text table, the restricted window [151665, 152689) of it
    (a slice at an offset), and the 7 x 1025-row speech stack (not a
    multiple of 16 rows): within the fp32 sum's bound (no output rounding)
    of the float64 product."""
    N, K = (152704 if table.startswith("text") else 7 * 1025), 2048
    q, s = _weights(cuda, N, K)
    s = s.reshape(-1)
    if table == "text_window":
        q, s = q[151665:152689], s[151665:152689]
    x = _x(cuda, rows, K)
    out = _one(x, q, s, head=True)
    assert out.dtype == torch.float32 and out.shape == (rows, q.shape[0])
    _check(out, *_exact_ref(x, q, s, True), False)


@pytest.mark.cuda
@pytest.mark.parametrize("head", [False, True])
def test_kernel_reads_the_plain_weights_bit_for_bit(cuda, head):
    """One-hot activation rows pick single weights out: the kernel's
    widened weight equals the plain version's exactly, bf16(bf16(q)
    bf16(s)) for a projection (scales that are not powers of two, so the
    rounding shows), float(q) s for a head; every K position of the
    lane-to-K map is hit."""
    N, K = 40, 2048
    q, s = _weights(cuda, N, K)
    s = s * 1.37
    ks = list(range(0, K, 129)) + [K - 1]
    for k0 in range(0, len(ks), 16):
        cols = ks[k0:k0 + 16]
        x = torch.zeros((len(cols), K), device="cuda", dtype=torch.bfloat16)
        x[torch.arange(len(cols)), cols] = 1.0
        out = _one(x, q, s.reshape(-1) if head else s, head=head)
        if head:
            want = (q[:, cols].float() * s).t()
        else:
            want = (q.to(torch.bfloat16)
                    * s.to(torch.bfloat16))[:, cols].t()
        assert torch.equal(out, want.to(out.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("group", ["q_k_v", "gate_up", "heads",
                                   "q_k_v_half"])
def test_grouped_launch_matches_plain(cuda, group, rows):
    """One launch over the weights that read the same x (q/k/v, gate/up,
    the text window and the speech stack; a tensor-parallel half of
    q/k/v): each output within the fp32 sum's bound of the plain version's
    product, one launch counted."""
    shapes, head = {"q_k_v": ([2048, 1024, 1024], False),
                    "gate_up": ([6144, 6144], False),
                    "heads": ([1024, 7175], True),
                    "q_k_v_half": ([1024, 512, 512], False)}[group]
    K = 2048
    ws = [_weights(cuda, N, K) for N in shapes]
    if head:
        ws = [(q, s.reshape(-1)) for q, s in ws]
    x = _x(cuda, rows, K)
    before = W.w8a16_group.launches
    outs = W.w8a16_group(x, [(q, s, None) for q, s in ws], head=head)
    assert W.w8a16_group.launches == before + 1
    for out, (q, s) in zip(outs, ws):
        assert out.shape == (rows, q.shape[0])
        _check(out, *_exact_ref(x, q, s, head), not head)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda):
    """K not a multiple of 16, more than 16 rows, a misaligned x row and
    an fp32 x raise; CPU tensors too (the CPU takes the plain version)."""
    q, s = _weights(cuda, 64, 72)
    x = _x(cuda, 4, 72)
    with pytest.raises(ValueError, match="multiple of 16"):
        _one(x, q, s)
    q, s = _weights(cuda, 64, 64)
    for bad in (torch.zeros((17, 64), device="cuda", dtype=torch.bfloat16),
                torch.zeros((4, 64), device="cuda"),
                torch.zeros((4, 72), device="cuda",
                            dtype=torch.bfloat16)[:, 4:68]):
        with pytest.raises(ValueError):
            _one(bad, q, s)
    with pytest.raises(ValueError, match="CUDA"):
        _one(x[:, :64].cpu(), q.cpu(), s.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["k_v", "gate_up"])
def test_kernel_under_a_cuda_graph_equals_eager(cuda, shape):
    """A captured call replays to the eager call's output, replay after
    replay, and the launch counter counts the capture's call once a
    replay."""
    from moss_ttsd_torch.ops import flash_attention as fa
    N, K = PROJ[shape]
    q, s = _weights(cuda, N, K)
    x = _x(cuda, 8, K)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = _one(x, q, s)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with fa.recording_launches() as rec, \
                torch.cuda.graph(graph, stream=side):
            out = _one(x, q, s)
    assert rec == {"w8a16_group": 1}
    fa.reset_launch_counts()
    for _ in range(3):
        graph.replay()
        fa.add_launch_counts(rec)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert W.w8a16_group.launches == 3


# -- the many-row kernel (a prefill) and the fp32 kernel -------------------------

PREFILL_ROWS = (17, 300, 640)
RAGGED = {"ragged": (200, 208)}     # N off the 128-row tile, K off 64


@pytest.mark.cuda
@pytest.mark.parametrize("rows", PREFILL_ROWS)
@pytest.mark.parametrize("shape", list(PROJ) + list(TP_HALF) + list(RAGGED))
def test_gemm_matches_plain_at_projection_shapes(cuda, shape, rows):
    """The many-row kernel (a prefill's rows: past the decode kernel's 16,
    over one and several 256-row tiles), bf16 out, at each projection
    shape, its tensor-parallel halves and a ragged one: within the fp32
    sum's bound of the plain version's product plus half a bf16 ulp
    (``_check``), and within a bf16 ulp of the plain version itself."""
    N, K = {**PROJ, **TP_HALF, **RAGGED}[shape]
    q, s = _weights(cuda, N, K)
    x = _x(cuda, rows, K)
    before = W.w8a16_gemm.launches
    out = W.w8a16_gemm(x, [(q, s, None)])[0]
    assert W.w8a16_gemm.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (rows, N)
    _check(out, *_exact_ref(x, q, s, False), True)
    plain = W.w8a16_plain(x, q, s).float()
    assert float(((out.float() - plain).abs()
                  - 2.0 ** -7 * plain.abs()).max()) <= 1e-3


@pytest.mark.cuda
def test_gemm_bias_and_row_stride(cuda):
    """The many-row kernel with a bias (added to the fp32 sum, rounded
    once) over x rows that are a strided view."""
    N, K = PROJ["k_v"]
    q, s = _weights(cuda, N, K)
    b = torch.randn(N, generator=cuda, device="cuda").to(torch.bfloat16)
    x = _x(cuda, 600, K)[::2]
    out = W.w8a16_gemm(x, [(q, s, b)])[0]
    ref, bound = _exact_ref(x, q, s, False)
    _check(out, ref + b.double(), bound, True)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [17, 40])
@pytest.mark.parametrize("table", ["text", "text_window", "speech"])
def test_gemm_matches_plain_at_the_heads(cuda, table, rows):
    """The heads through the many-row kernel (fp32 out, the scale on the
    fp32 sum): the whole text table, its restricted window, the speech
    stack; within the fp32 sum's bound of the float64 product."""
    N, K = (152704 if table.startswith("text") else 7 * 1025), 2048
    q, s = _weights(cuda, N, K)
    s = s.reshape(-1)
    if table == "text_window":
        q, s = q[151665:152689], s[151665:152689]
    x = _x(cuda, rows, K)
    out = W.w8a16_gemm(x, [(q, s, None)], head=True)[0]
    assert out.dtype == torch.float32 and out.shape == (rows, q.shape[0])
    _check(out, *_exact_ref(x, q, s, True), False)


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["q_k_v", "gate_up", "heads"])
def test_gemm_grouped_launch_matches_plain(cuda, group):
    """One many-row launch over the weights that read the same x (300
    rows): each output within the fp32 sum's bound, one launch counted."""
    shapes, head = {"q_k_v": ([2048, 1024, 1024], False),
                    "gate_up": ([6144, 6144], False),
                    "heads": ([1024, 7175], True)}[group]
    K = 2048
    ws = [_weights(cuda, N, K) for N in shapes]
    if head:
        ws = [(q, s.reshape(-1)) for q, s in ws]
    x = _x(cuda, 300, K)
    before = W.w8a16_gemm.launches
    outs = W.w8a16_gemm(x, [(q, s, None) for q, s in ws], head=head)
    assert W.w8a16_gemm.launches == before + 1
    for out, (q, s) in zip(outs, ws):
        assert out.shape == (300, q.shape[0])
        _check(out, *_exact_ref(x, q, s, head), not head)


@pytest.mark.cuda
@pytest.mark.parametrize("head", [False, True])
def test_gemm_reads_the_plain_weights_bit_for_bit(cuda, head):
    """One-hot rows (17 of them, past the decode kernel, among 300 rows
    of zeros: two activation tiles) pick single weights out: the widened
    operand equals the plain version's weight exactly."""
    N, K = 200, 2048
    q, s = _weights(cuda, N, K)
    s = s * 1.37
    cols = list(range(0, K, 129)) + [K - 1]
    x = torch.zeros((300, K), device="cuda", dtype=torch.bfloat16)
    x[torch.arange(len(cols)) * 16, cols] = 1.0
    out = W.w8a16_gemm(x, [(q, s.reshape(-1) if head else s, None)],
                       head=head)[0]
    if head:
        want = (q[:, cols].float() * s).t()
    else:
        want = (q.to(torch.bfloat16) * s.to(torch.bfloat16))[:, cols].t()
    assert torch.equal(out[torch.arange(len(cols)) * 16],
                       want.to(out.dtype))
    rest = torch.ones(300, dtype=torch.bool)
    rest[torch.arange(len(cols)) * 16] = False
    assert not bool(out[rest.cuda()].any())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 40, 130])
@pytest.mark.parametrize("head", [False, True])
def test_simt_matches_plain_in_fp32(cuda, rows, head):
    """fp32 x (an fp32 compute dtype on the card), N off the 64-row tile:
    a projection reads fp32(q s) (with an fp32 bias), a head float(q)
    with s on the sum; within the fp32 sum's bound of the float64 product
    (a head's last product by s adds one fp32 rounding), and near the
    plain version (cuBLAS in fp32, TF32 off)."""
    N, K = 1000, 1024
    q, s = _weights(cuda, N, K)
    x = torch.randn((rows, K), generator=cuda, device="cuda")
    xd = x.double()
    if head:
        s = s.reshape(-1)
        w = q.double()
        ref = (xd @ w.t()) * s.double()
        bound = (xd.abs() @ w.abs().t()) * s.double()
        b = None
    else:
        w = (q.float() * s).double()
        b = torch.randn(N, generator=cuda, device="cuda")
        ref = xd @ w.t() + b.double()
        bound = xd.abs() @ w.abs().t() + b.double().abs()
    before = W.w8a16_simt.launches
    out = W.w8a16_simt(x, [(q, s, b)], head=head)[0]
    assert W.w8a16_simt.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (rows, N)
    tol = 2.0 * (K + 1) * 2.0 ** -24 * bound + 2.0 ** -23 * ref.abs()
    assert float(((out.double() - ref).abs() - tol).max()) <= 0.0
    plain = W.w8a16_plain(x, q, s, b, head).double()
    assert float(((out.double() - plain).abs() - 2.0 * tol).max()) <= 0.0


@pytest.mark.cuda
def test_product_chooses_by_rows_and_type_on_the_card(cuda, monkeypatch):
    """On the card ``w8a16_product`` never takes the plain version: bf16
    x of at most 16 rows goes to the decode kernel, more rows to the
    many-row kernel, fp32 x to the fp32 kernel, and fp16 x raises."""
    def refuse(*a, **k):
        raise AssertionError("the card took the plain version")
    monkeypatch.setattr(W, "w8a16_plain", refuse)
    q, s = _weights(cuda, 64, 128)
    cases = [((2, 8), torch.bfloat16, "w8a16_group"),
             ((2, 9), torch.bfloat16, "w8a16_gemm"),
             ((3,), torch.float32, "w8a16_simt"),
             ((50,), torch.float32, "w8a16_simt")]
    for lead, dt, want in cases:
        before = {n: getattr(W, n).launches
                  for n in ("w8a16_group", "w8a16_gemm", "w8a16_simt")}
        x = torch.randn((*lead, 128), generator=cuda, device="cuda").to(dt)
        y = W.w8a16_product(x, q, s)
        assert y.shape == (*lead, 64) and y.dtype == dt
        for n, c in before.items():
            assert getattr(W, n).launches == c + (n == want)
    with pytest.raises(ValueError, match="no kernel"):
        W.w8a16_product(torch.zeros((2, 128), device="cuda",
                                    dtype=torch.float16), q, s)


@pytest.mark.cuda
def test_int8_engine_decode_step_runs_the_kernel(cuda, monkeypatch):
    """An int8 engine (bf16) on the card: each decode step, eager or
    replayed, launches the decode kernel four times a layer (q/k/v
    grouped, o, gate/up grouped, down) and once a head; the prefill's many
    rows launch the many-row kernel four times a layer; nothing takes the
    plain version (no copy of a weight)."""
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             LMConfig, SamplingConfig)
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.ops import flash_attention as fa
    cfg = LMConfig(dtype="bfloat16", param_dtype="float32").tiny(
        head_dim=64, speech_token_range=(0, 160))
    sampling = SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=False, temperature=None, top_k=None, top_p=None)
        for _ in range(cfg.channels)], max_new_tokens=40)
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    with torch.no_grad():       # EOS logit 0: rows decode their budgets
        model.embed_text[cfg.eos_token_id] = 0.0
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cuda",
                           quant="int8")

    def refuse(*a, **k):
        raise AssertionError("the card took the plain version")
    monkeypatch.setattr(W, "w8a16_plain", refuse)
    rng = np.random.default_rng(0)
    prompt = np.full((3, 20, cfg.channels), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (3, 20))
    mask = np.ones((3, 20), np.int64)
    per_step = 4 * cfg.num_hidden_layers + 2    # q/k/v, o, gate/up, down
    counts = []
    for n in (20, 30):
        fa.reset_launch_counts()
        res = eng.generate(prompt, mask, n)
        counts.append((W.w8a16_group.launches, res.steps,
                       W.w8a16_gemm.launches))
    (a, sa, ga), (b, sb, gb) = counts
    assert sb > sa and a == per_step * sa and b == per_step * sb
    assert ga == gb == 4 * cfg.num_hidden_layers        # one prefill each
