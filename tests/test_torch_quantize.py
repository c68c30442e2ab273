"""The port's int8 quantization against the JAX package's (tiny config,
fp32, CPU): the same int8 bytes and scales for the weights
(``quantize_lm_params``, and the converter of the JAX quantized tree), for
the KV cache (``quantize_kv``, including an all-zero row and exact
half-step ties), and the same w8a16 product (``QLinear`` vs ``QDense``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.models.lm import QDense  # noqa: E402
from moss_ttsd_tpu.ops import quantize as jq  # noqa: E402
from moss_ttsd_tpu.ops.pallas_attention import quantize_kv as jquantize_kv  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.models.lm import QLinear  # noqa: E402
from moss_ttsd_torch.ops import quantize as pq  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import lm_state_from_jax  # noqa: E402
from tests.test_torch_lm import jax_tiny  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_same_state(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("bias", [False, True])
def test_quantize_lm_params_bytes_equal_jax(bias):
    """Port quantization of the exported float weights == the converted
    JAX quantized tree, byte for byte (int8 weights and fp32 scales)."""
    jcfg, params = jax_tiny(1, attention_bias=bias)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    via_port = pq.quantize_lm_params(lm_state_from_jax(params, cfg))
    via_jax = lm_state_from_jax(_np_tree(jq.quantize_lm_params(params)), cfg)
    assert_same_state(via_port, via_jax)
    assert via_port["layers.0.q_proj.weight_q"].dtype == torch.int8
    assert via_port["layers.0.q_proj.weight_s"].shape == (
        cfg.num_attention_heads * cfg.head_dim, 1)
    assert via_port["embed_speech_s"].shape == (
        cfg.channels - 1, cfg.speech_vocab_size, 1)


def test_quantized_tree_detection_and_dequantize_match_jax():
    jcfg, params = jax_tiny(2)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    flat = lm_state_from_jax(params, cfg)
    q = pq.quantize_lm_params(flat)
    assert pq.is_quantized_tree(q) and not pq.is_quantized_tree(flat)
    ref = lm_state_from_jax(
        _np_tree(jq.dequantize_lm_params(jq.quantize_lm_params(params))), cfg)
    assert_same_state(pq.dequantize_lm_params(q), ref)


def _tie_rows():
    """Rows whose amax is 127 (scale exactly 1), so x / s lands exactly on
    half steps; one all-zero row (scale floor 1e-8)."""
    x = np.zeros((4, 16), np.float32)
    x[0] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, -1.5, 126.5,
            -126.5, 0, 3, -3, 4.5, -4.5, 0.25, -0.75]
    x[1] = -x[0]
    x[2, :] = 0.0
    x[3] = np.arange(16) - 7.5
    return x


@pytest.mark.parametrize("case", ["random", "ties", "bf16"])
def test_quantize_kv_bytes_equal_jax(case):
    rng = np.random.default_rng(8)
    if case == "ties":
        x = _tie_rows()
    else:
        x = rng.standard_normal((3, 4, 17, 32)).astype(np.float32) * 3
        x[1, 2, 5] = 0.0                               # an all-zero row
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    if case == "bf16":
        jx, px = jx.astype(jnp.bfloat16), px.to(torch.bfloat16)
    jqv, js = jquantize_kv(jx)
    pqv, ps = pq.quantize_kv(px)
    assert pqv.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    if case == "ties":
        np.testing.assert_array_equal(pqv.numpy()[0, :9],
                                      [127, 3, -3, 1, 0, 2, -1, 127, -126])
        np.testing.assert_array_equal(pqv.numpy()[2], 0)
        assert ps.numpy()[2] == np.float32(1e-8)


@pytest.mark.parametrize("bias", [False, True])
def test_qlinear_matches_jax_qdense(bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    kq, ks = jq._quantize(jnp.asarray(w), axis=-2)
    tree = {"kernel_q": kq, "kernel_s": ks}
    if bias:
        tree["bias"] = jnp.asarray(rng.standard_normal(40).astype(np.float32))
    ref = QDense(40, use_bias=bias, dtype=jnp.float32).apply(
        {"params": tree}, jnp.asarray(x))
    lin = QLinear(24, 40, bias=bias)
    with torch.no_grad():
        lin.weight_q.copy_(torch.from_numpy(np.asarray(kq).T.copy()))
        lin.weight_s.copy_(torch.from_numpy(np.asarray(ks).T.copy()))
        if bias:
            lin.bias.copy_(torch.tensor(np.asarray(tree["bias"])))
        out = lin(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
