"""The port's AsteroidLM against the JAX AsteroidLM on the same weights
(LMConfig().tiny(), fp32, CPU): cache-free logits, prefill + one cached
decode step, and the reference-name loader."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.core.config import LMConfig as JLMConfig  # noqa: E402
from moss_ttsd_tpu.models import lm as jlm  # noqa: E402
from moss_ttsd_tpu.utils.convert_lm import export_asteroid_state_dict  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.models.lm import AsteroidLM, init_cache  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import (  # noqa: E402
    lm_state_from_jax, load_reference_lm_state_dict)

ATOL = 1e-4      # fp32, float reassociation across frameworks


def jax_tiny(seed=0, **overrides):
    cfg = JLMConfig(dtype="float32", param_dtype="float32").tiny(**overrides)
    params = jlm.AsteroidLM(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, cfg.channels), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    if cfg.attention_bias:
        # flax inits biases to zero: randomize them so the test sees them
        rng = np.random.default_rng(seed)
        blk = params["params"]["layers"]["block"]
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            b = blk[proj]["bias"]
            blk[proj]["bias"] = rng.standard_normal(b.shape).astype(np.float32) * 0.1
    return cfg, params


def port_model(jcfg, params):
    cfg = LMConfig.from_dict(jcfg.to_dict())
    model = AsteroidLM(cfg)
    model.load_state_dict(lm_state_from_jax(params, cfg))
    return cfg, model.eval()


def rand_ids(cfg, rng, B, T):
    ids = np.zeros((B, T, cfg.channels), np.int64)
    ids[..., 0] = rng.integers(0, cfg.vocab_size, (B, T))
    ids[..., 1:] = rng.integers(0, cfg.speech_vocab_size,
                                (B, T, cfg.channels - 1))
    return ids


@pytest.mark.parametrize("bias", [False, True])
def test_cache_free_logits_match(bias):
    jcfg, params = jax_tiny(0, attention_bias=bias)
    cfg, model = port_model(jcfg, params)
    rng = np.random.default_rng(1)
    ids = rand_ids(cfg, rng, 2, 11)
    mask = np.ones((2, 11), np.int64)
    mask[1, :4] = 0                                  # left padding
    jt, js = jlm.AsteroidLM(jcfg).apply(params, jnp.asarray(ids),
                                        jnp.asarray(mask))
    with torch.no_grad():
        pt, ps = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert pt.dtype == torch.float32 and ps.dtype == torch.float32
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL)


@pytest.mark.parametrize("bias", [False, True])
def test_prefill_and_cached_decode_step_match(bias):
    """Prefill of a left-padded batch into the head-major cache, then one
    decode step reading it (the port's flash_prefill / flash_decode_hs
    plain versions vs the JAX backbone's XLA path)."""
    jcfg, params = jax_tiny(2, attention_bias=bias)
    cfg, model = port_model(jcfg, params)
    rng = np.random.default_rng(3)
    B, T, S = 2, 9, 16
    ids = rand_ids(cfg, rng, B, T)
    attn = np.ones((B, T), np.int64)
    attn[0, :3] = 0
    pos = np.maximum(np.cumsum(attn, axis=1) - 1, 0)
    kv = np.zeros((B, S), bool)
    kv[:, :T] = attn.astype(bool)
    nxt = rand_ids(cfg, rng, B, 1)
    kv2 = kv.copy()
    kv2[:, T] = True
    pos2 = pos[:, -1:] + 1

    jm = jlm.AsteroidLM(jcfg)
    jcache = jlm.init_cache(jcfg, B, S, jnp.float32)
    jh, jcache = jm.apply(params, jnp.asarray(ids), jnp.asarray(pos),
                          jnp.asarray(kv), jcache, 0,
                          method=jlm.AsteroidLM.backbone)
    jh2, jcache = jm.apply(params, jnp.asarray(nxt), jnp.asarray(pos2),
                           jnp.asarray(kv2), jcache, T,
                           method=jlm.AsteroidLM.backbone)

    with torch.no_grad():
        cache = init_cache(cfg, B, S, torch.float32, device="cpu")
        ph, cache = model.backbone(torch.from_numpy(ids),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(kv), cache, 0)
        ph2, cache = model.backbone(torch.from_numpy(nxt),
                                    torch.from_numpy(pos2),
                                    torch.from_numpy(kv2), cache, T)
    # valid (non-padded) positions of the prefill; every row of the step
    np.testing.assert_allclose(ph.numpy()[1], np.asarray(jh)[1], atol=ATOL)
    np.testing.assert_allclose(ph.numpy()[0, 3:], np.asarray(jh)[0, 3:],
                               atol=ATOL)
    np.testing.assert_allclose(ph2.numpy(), np.asarray(jh2), atol=ATOL)
    # the cache holds the same k/v at every written valid slot
    for name in ("k", "v"):
        got = cache[name].numpy()
        ref = np.asarray(jcache[name])
        np.testing.assert_allclose(got[:, 1, :, :T + 1], ref[:, 1, :, :T + 1],
                                   atol=ATOL)
        np.testing.assert_allclose(got[:, 0, :, 3:T + 1],
                                   ref[:, 0, :, 3:T + 1], atol=ATOL)


@pytest.mark.parametrize("bias", [False, True])
def test_reference_state_dict_loads_same_model(bias):
    jcfg, params = jax_tiny(4, attention_bias=bias)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    via_jax = lm_state_from_jax(params, cfg)
    via_ref = load_reference_lm_state_dict(
        export_asteroid_state_dict(params, jcfg), cfg)
    assert via_jax.keys() == via_ref.keys()
    for k in via_jax:
        torch.testing.assert_close(via_ref[k], via_jax[k], rtol=0, atol=0)
    AsteroidLM(cfg).load_state_dict(via_ref)          # strict: every name


def test_init_random_is_seeded():
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny()
    a = AsteroidLM.init_random(cfg, seed=3, device="cpu").state_dict()
    b = AsteroidLM.init_random(cfg, seed=3, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.isfinite(a["embed_text"]).all()


def _cached_hidden(jcfg, params, cfg, model, steps=3, seed=3):
    """A left-padded prefill, then ``steps`` decode steps through the cache,
    in both packages on the same inputs: [(port, JAX)] hidden states of the
    valid prefill rows and of every decode step."""
    rng = np.random.default_rng(seed)
    B, T, S = 2, 9, 16
    ids = rand_ids(cfg, rng, B, T + steps)
    attn = np.ones((B, T), np.int64)
    attn[0, :3] = 0
    pos = np.maximum(np.cumsum(attn, axis=1) - 1, 0)
    kv = np.zeros((B, S), bool)
    kv[:, :T] = attn.astype(bool)
    jm = jlm.AsteroidLM(jcfg)
    jcache = jlm.init_cache(jcfg, B, S, jnp.float32)
    cache = init_cache(cfg, B, S, torch.float32, device="cpu")
    out = []
    seg, p, at = ids[:, :T], pos, 0
    with torch.no_grad():
        for s in range(steps + 1):
            jh, jcache = jm.apply(params, jnp.asarray(seg), jnp.asarray(p),
                                  jnp.asarray(kv), jcache, at,
                                  method=jlm.AsteroidLM.backbone)
            ph, cache = model.backbone(T_(seg), T_(p), T_(kv), cache, at)
            if s == 0:
                out += [(ph.numpy()[0, 3:], np.asarray(jh)[0, 3:]),
                        (ph.numpy()[1], np.asarray(jh)[1])]
            else:
                out.append((ph.numpy(), np.asarray(jh)))
            at = T + s
            kv[:, at] = True
            seg, p = ids[:, at:at + 1], p[:, -1:] + 1
    return out


def T_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CACHED_VARIANTS = {
    "ablate_norms": dict(ablate_norms=True),
    "ablate_rope": dict(ablate_rope=True),
    "ablate_attention": dict(ablate_attention=True),
    "ablate_all": dict(ablate_norms=True, ablate_rope=True,
                       ablate_attention=True),
    "xla": dict(attn_impl="xla"),
    "xla_kv8": dict(attn_impl="xla", kv_quant="int8"),
}


@pytest.mark.parametrize("variant", list(CACHED_VARIANTS))
def test_cached_backbone_variants_match_jax(variant):
    """The bench-only stubs (every RMSNorm x*w, no rotations, attention =
    q) and the dense ``attn_impl="xla"`` backend over a full-precision and
    an int8 cache: a prefill and 3 decode steps equal JAX's AsteroidLM with
    the same config (JAX's CPU path) within 1e-5. Outside the xla variants
    the port attends through its kernels' plain versions."""
    jcfg, params = jax_tiny(5, **CACHED_VARIANTS[variant])
    cfg, model = port_model(jcfg, params)
    for got, ref in _cached_hidden(jcfg, params, cfg, model):
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_xla_backend_launches_no_kernel_wrapper(monkeypatch):
    """Under attn_impl="xla" the sequential prefill and decode never call
    a kernel wrapper (on the card they would launch none); the pool's
    extents still would (models/lm.py)."""
    from moss_ttsd_torch.models import lm as plm
    calls = []
    for name in ("flash_prefill", "flash_decode_hs", "flash_decode_int8_hs"):
        monkeypatch.setattr(plm, name, lambda *a, _n=name, **k:
                            calls.append(_n))
    for extra in ({}, dict(kv_quant="int8")):
        jcfg, params = jax_tiny(5, attn_impl="xla", **extra)
        cfg, model = port_model(jcfg, params)
        _cached_hidden(jcfg, params, cfg, model, steps=1)
    assert calls == []
