"""The port on a CUDA card: each Hopper kernel against its plain version,
``quantize_kv`` on the card against the CPU, and the tiny LM engine (bf16
path and int8 serving) on the card (kernels) against the same engine on the
CPU (plain versions). Imports no JAX, so it runs on a machine with the card
and no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Every test carries the ``cuda`` marker and skips without a CUDA device (the
kernels have no CPU mode)."""
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
@pytest.mark.parametrize("T,pads", [(121, (0, 30)), (7, (3, 0)), (1, (0, 1))])
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
    fa.reset_launch_counts()
    for ext in (200, torch.tensor([200, 150], dtype=torch.int32,
                                  device="cuda"), None, 1):
        out = fa.flash_decode_int8_hs(q, kq, ks, vq, vs, valid, D ** -0.5,
                                      extent=ext, layer=2)
        ref = fa.flash_decode_int8_hs_plain(q, kq, ks, vq, vs, valid,
                                            D ** -0.5, extent=ext, layer=2,
                                            out_dtype=torch.float32)
        _close(out, ref, dtype)
    assert fa.launch_counts()["flash_decode_int8_hs"] == 4
    empty = torch.zeros_like(valid)                  # no valid key at all
    out = fa.flash_decode_int8_hs(q, kq[0], ks[0], vq[0], vs[0], empty,
                                  D ** -0.5, extent=S)
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
