"""The port's codec training against the JAX package (CPU, fp32, tiny
sizes): the device resampler, the RVQ train mode (dropout, skip, EMA
statistics, dead-code candidates), the EMA functions, k-means, the
training round trip, the k-means bootstrap and two train steps from the
same weights, the export of a trained codec to the JAX tree, the train
state's checkpoint, and the data-parallel step in two ``gloo`` processes.

JAX's threefry and torch's Philox draw differently, so every draw of the
JAX code (dropout counts, skip mask, dead-code candidates, k-means starts)
is made here with JAX's own calls from the same key, in JAX's order, and
passed to the port as an override: the port is held to JAX's numbers."""
import dataclasses
import multiprocessing
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.core.config import CodecConfig as JCodecConfig  # noqa: E402
from moss_ttsd_tpu.core.config import RVQConfig as JRVQConfig  # noqa: E402
from moss_ttsd_tpu.models.codec import rvq as jrvq  # noqa: E402
from moss_ttsd_tpu.models.codec.model import XYTokenizerModule as JModule  # noqa: E402
from moss_ttsd_tpu.ops import dsp as jdsp  # noqa: E402
from moss_ttsd_tpu.train import codec_step as jcs  # noqa: E402
from moss_ttsd_tpu.train.step import make_optimizer as jmake_optimizer  # noqa: E402
from moss_ttsd_torch.core.checkpoint import (restore_train_state,  # noqa: E402
                                             save_train_state)
from moss_ttsd_torch.core.config import RVQConfig  # noqa: E402
from moss_ttsd_torch.models.codec import rvq  # noqa: E402
from moss_ttsd_torch.models.codec.model import (XYTokenizerModule,  # noqa: E402
                                                _init_random)
from moss_ttsd_torch.ops import dsp  # noqa: E402
from moss_ttsd_torch.train import codec_step as cs  # noqa: E402
from moss_ttsd_torch.train.step import make_optimizer  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import (codec_state_from_jax,  # noqa: E402
                                               codec_state_to_jax)
from tests.test_torch_train import assert_params_close  # noqa: E402
import torch_codec_train_ref as tref  # noqa: E402

LR = 1e-3
WAV_T = 48000           # 3 s: 38 codes a row


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def codes_len(samples: int) -> int:
    """Codes a window of ``samples`` holds: 100 Hz mel, /2, then /4 after
    padding to a multiple of 4."""
    return -(-(samples // 160 // 2) // 4)


# -- JAX's draws, in JAX's order ---------------------------------------------

def jax_train_draws(qc, key, G, T):
    """``ResidualVQ.train_call``'s draws from ``key`` over G rows of T
    codes (rvq.py: the dropout counts, the skip mask, the candidates)."""
    nq, K = qc.num_quantizers, qc.codebook_size
    rng_drop, rng_skip, rng_samp = jax.random.split(key, 3)
    n_active = np.full((G,), nq + 1, np.float32)
    n_dropout = int(G * qc.quantizer_dropout)
    if n_dropout > 0:
        drawn = np.asarray(jax.random.randint(rng_drop, (G,), 1, nq + 1))
        n_active[:n_dropout] = drawn[:n_dropout]
    if qc.skip_rvq_ratio > 0:
        skip = np.array(jax.random.uniform(rng_skip, (G,))
                          < qc.skip_rvq_ratio)
        if skip.all():
            skip[0] = False
    else:
        skip = np.zeros((G,), bool)
    idx = jax_sample_idx(qc, rng_samp, skip, T)
    return {"n_active_override": _t(n_active), "skip_override": _t(skip),
            "sample_idx_override": _t(idx)}


def jax_sample_idx(qc, rng_samp, skip, T):
    notskip = jnp.asarray(~skip, jnp.float32)
    flat_p = jnp.repeat(notskip / jnp.maximum(jnp.sum(notskip), 1.0) / T, T)
    keys = jax.random.split(rng_samp, qc.num_quantizers)
    return np.stack([np.asarray(jax.random.choice(
        k, len(skip) * T, (qc.codebook_size,), replace=True, p=flat_p))
        for k in keys]).astype(np.int64)


def jax_kmeans_idx(qc, key, N):
    """``kmeans_init_call``'s starting rows: a split a stage, then
    ``kmeans_init``'s permutation (N >= K) or randint."""
    out = []
    for _ in range(qc.num_quantizers):
        key, sub = jax.random.split(key)
        K = qc.codebook_size
        idx = (jax.random.permutation(sub, N)[:K] if N >= K
               else jax.random.randint(sub, (K,), 0, N))
        out.append(np.asarray(idx))
    return _t(np.stack(out).astype(np.int64))


# -- the resampler -------------------------------------------------------------

@pytest.mark.parametrize("orig,new", [(16000, 24000), (24000, 16000)])
def test_resample_torch_matches_jax(orig, new):
    x = np.random.default_rng(0).standard_normal((3, 4001)).astype(np.float32)
    ref = np.asarray(jdsp.resample_jax(jnp.asarray(x), orig, new))
    got = dsp.resample_torch(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


# -- the RVQ train mode ---------------------------------------------------------

RVQ_KW = dict(input_dim=24, rvq_dim=16, output_dim=20, num_quantizers=3,
              codebook_size=12, codebook_dim=16, quantizer_dropout=0.5,
              skip_rvq_ratio=0.5, threshold_ema_dead=2.0)


@pytest.fixture(scope="module")
def rvq_pair():
    jcfg = JRVQConfig(**RVQ_KW)
    B, T = 4, 10
    z = np.random.default_rng(7).standard_normal(
        (B, T, jcfg.input_dim)).astype(np.float32)
    lens = np.array([10, 7, 10, 4], np.int64)
    jmod = jrvq.ResidualVQ(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(lens)))
    p = params["params"]
    mod = rvq.ResidualVQ(RVQConfig(**RVQ_KW))
    mod.load_state_dict({
        "codebook": _t(p["codebook"]),
        "input_proj.weight": _t(p["input_proj"]["kernel"].T),
        "input_proj.bias": _t(p["input_proj"]["bias"]),
        "output_proj.weight": _t(p["output_proj"]["kernel"].T),
        "output_proj.bias": _t(p["output_proj"]["bias"])})
    return jcfg, jmod, params, mod, z, lens


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / max(
        np.abs(np.asarray(want)).max(), 1e-30)


def test_train_call_matches_jax(rvq_pair):
    """Dropout (rows 0 and 1 stop after 1 and 2 of 3 stages) and skip
    (rows 1 and 3) pinned, the candidates drawn as JAX draws them."""
    jcfg, jmod, params, mod, z, lens = rvq_pair
    B, T = z.shape[:2]
    n_active = np.array([1, 2, 4, 4], np.float32)
    skip = np.array([False, True, False, True])
    key = jax.random.PRNGKey(1)
    zq, codes, commits, _, stats = jmod.apply(
        params, jnp.asarray(z), jnp.asarray(lens), key,
        method=jrvq.ResidualVQ.train_call,
        n_active_override=jnp.asarray(n_active),
        skip_override=jnp.asarray(skip))
    idx = jax_sample_idx(jcfg, jax.random.split(key, 3)[2], skip, T)
    got = mod.train_call(_t(z), _t(lens), n_active_override=_t(n_active),
                         skip_override=_t(skip),
                         sample_idx_override=_t(idx))
    gzq, gcodes, gcommits, _, gstats = got
    assert _rel(gzq.detach(), zq) <= 1e-6
    assert _rel(gcommits.detach(), commits) <= 1e-6
    np.testing.assert_array_equal(gcodes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(gstats["cluster_new"].numpy(),
                                  np.asarray(stats["cluster_new"]))
    for k in ("embed_sum", "samples"):
        np.testing.assert_allclose(gstats[k].numpy(), np.asarray(stats[k]),
                                   atol=1e-5, err_msg=k)
    # commits reach the encoder (z) and never the codebook
    z_in = _t(z).requires_grad_(True)
    mod.zero_grad(set_to_none=True)
    mod.train_call(z_in, _t(lens), skip_override=_t(skip),
                   n_active_override=_t(n_active),
                   sample_idx_override=_t(idx))[2].sum().backward()
    assert float(z_in.grad.abs().sum()) > 0
    assert mod.codebook.grad is None


def test_train_call_draws_from_its_generator(rvq_pair):
    """Without overrides the draws come from the generator: the same seed
    gives the same result, and the first int(B x 0.5) rows draw counts."""
    mod, z, lens = rvq_pair[3], rvq_pair[4], rvq_pair[5]
    runs = [mod.train_call(_t(z), _t(lens),
                           torch.Generator().manual_seed(3))
            for _ in range(2)]
    for a, b in zip(runs[0][4].values(), runs[1][4].values()):
        assert torch.equal(a, b)
    n_active, skip = mod.draw_dropout_and_skip(
        4, torch.Generator().manual_seed(3), "cpu")
    assert bool((n_active[:2] <= 3).all()) and bool((n_active[2:] == 4).all())
    assert not bool(skip.all())


def test_ema_functions_match_jax():
    g = np.random.default_rng(3)
    nq, K, D, N = 3, 12, 16, 40
    cs_, ea = g.random((nq, K)).astype(np.float32) * 3, \
        g.standard_normal((nq, K, D)).astype(np.float32)
    cn, es = g.integers(0, 5, (nq, K)).astype(np.float32), \
        g.standard_normal((nq, K, D)).astype(np.float32)
    ref = jrvq.ema_update_stacked(*map(jnp.asarray, (cs_, ea, cn, es)))
    got = rvq.ema_update_stacked(*map(_t, (cs_, ea, cn, es)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    enc = g.standard_normal((N, D)).astype(np.float32)
    idx = g.integers(0, K, N)
    ref = jrvq.ema_update(jnp.asarray(cs_[0]), jnp.asarray(ea[0]),
                          jnp.asarray(ea[0]), jnp.asarray(enc),
                          jnp.asarray(idx))
    got = rvq.ema_update(_t(cs_[0]), _t(ea[0]), _t(ea[0]), _t(enc), _t(idx))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    # dead-code replacement with JAX's draw of the K candidates
    key = jax.random.PRNGKey(4)
    ref = jrvq.replace_dead_codes(jnp.asarray(ea[0]), jnp.asarray(cs_[0]),
                                  jnp.asarray(enc), key)
    draw = np.asarray(jax.random.randint(key, (K,), 0, N))
    got = rvq.replace_dead_codes(_t(ea[0]), _t(cs_[0]), _t(enc),
                                 idx_override=_t(draw))
    assert bool((_t(cs_[0]) < 2.0).any())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_kmeans_init_matches_jax():
    g = np.random.default_rng(13)
    N, D, K = 64, 6, 8
    x = g.standard_normal((N, D)).astype(np.float32)
    means0 = x[g.permutation(N)[:K]]
    ref_m, ref_b = jrvq.kmeans_init(jnp.asarray(x), K, jax.random.PRNGKey(0),
                                    init_means=jnp.asarray(means0))
    got_m, got_b = rvq.kmeans_init(_t(x), K, init_means=_t(means0))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), atol=1e-5)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))
    # its own draw: K distinct rows when N >= K, K rows when N < K
    m, b = rvq.kmeans_init(_t(x), K, torch.Generator().manual_seed(0))
    assert m.shape == (K, D) and float(b.sum()) == N
    m, b = rvq.kmeans_init(_t(x[:5]), K, torch.Generator().manual_seed(0))
    assert m.shape == (K, D) and float(b.sum()) == 5


@pytest.mark.parametrize("T", [10, 3])        # N >= K and N < K
def test_kmeans_init_call_matches_jax(rvq_pair, T):
    jcfg, jmod, params, mod, z, lens = rvq_pair
    z, lens = z[:, :T], np.minimum(lens, T)
    key = jax.random.PRNGKey(2)
    ref_cb, ref_bins = jmod.apply(params, jnp.asarray(z), jnp.asarray(lens),
                                  key, method=jrvq.ResidualVQ.kmeans_init_call)
    idx = jax_kmeans_idx(jcfg, key, z.shape[0] * T)
    with torch.no_grad():
        cb, bins = mod.kmeans_init_call(_t(z), _t(lens),
                                        init_idx_override=idx)
    np.testing.assert_allclose(cb.numpy(), np.asarray(ref_cb), atol=1e-5)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(ref_bins))


# -- the codec: round trip, bootstrap and steps --------------------------------

def _codec_cfgs():
    """``torch_codec_train_ref.tiny_cfg`` (dropout, skip, 8 codes a
    stage) in both packages."""
    cfg = tref.tiny_cfg()
    jc = JCodecConfig().tiny()
    return dataclasses.replace(jc, quantizer=JRVQConfig(
        **dataclasses.asdict(cfg.quantizer))), cfg


@pytest.fixture(scope="module")
def codec():
    """JAX params of a random tiny codec (the port's seeded init through
    ``codec_state_to_jax``), a batch of 2 x 3 s with a padded row."""
    jcfg, cfg = _codec_cfgs()
    module = XYTokenizerModule(cfg)
    _init_random(module, 0, "cpu")
    jparams = codec_state_to_jax(module.state_dict(), cfg)
    wav = (np.random.default_rng(17).standard_normal((2, WAV_T)) * 0.1
           ).astype(np.float32)
    lens = np.array([WAV_T, WAV_T - 8000], np.int64)
    return jcfg, cfg, jparams, wav, lens


def _port_state(cfg, jparams):
    opt = make_optimizer(learning_rate=LR, total_steps=10, warmup_ratio=0.0)
    return cs.init_codec_train_state(
        cfg, opt, params=codec_state_from_jax(jparams, cfg),
        device="cpu"), opt


@pytest.fixture(scope="module")
def jax_run(codec):
    """JAX: the k-means bootstrap (key 1, the batch at full length) and two
    jitted steps (keys 2, 3) on the padded batch, from ``codec``'s weights;
    the state after each, the metrics, and the draws each made."""
    jcfg, cfg, jparams, wav, lens = codec
    opt = jmake_optimizer(learning_rate=LR, total_steps=10, warmup_ratio=0.0)
    state = jcs.init_codec_train_state(jcfg, opt, params=jparams)
    w, l = jnp.asarray(wav), jnp.asarray(lens, jnp.int32)
    state = jcs.kmeans_bootstrap(jcfg, state, w, jnp.full((2,), WAV_T),
                                 jax.random.PRNGKey(1))
    T = codes_len(WAV_T)
    run = {"kmeans_idx": jax_kmeans_idx(jcfg.quantizer,
                                        jax.random.PRNGKey(1), 2 * T),
           "states": [state], "metrics": [], "draws": []}
    step = jax.jit(jcs.make_codec_train_step(jcfg, opt))
    for n in range(2):
        key = jax.random.PRNGKey(2 + n)
        run["draws"].append(jax_train_draws(jcfg.quantizer, key, 2, T))
        state, m = step(state, {"wav": w, "lengths": l}, key)
        run["states"].append(state)
        run["metrics"].append({k: float(v) for k, v in m.items()})
    return run


def test_train_forward_matches_jax(codec):
    jcfg, cfg, jparams, wav, lens = codec
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, w, l, k: JModule(jcfg).apply(
        p, w, l, k, method=JModule.train_forward))(
        jparams, jnp.asarray(wav), jnp.asarray(lens, jnp.int32), key)
    draws = jax_train_draws(jcfg.quantizer, key, 2, codes_len(WAV_T))
    state, _ = _port_state(cfg, jparams)
    out = state.module.train_forward(_t(wav), _t(lens), **draws)
    assert out["codes"].shape == ref["codes"].shape
    np.testing.assert_array_equal(out["codes"].numpy(),
                                  np.asarray(ref["codes"]))
    np.testing.assert_array_equal(out["wav_lengths"].numpy(),
                                  np.asarray(ref["wav_lengths"]))
    assert _rel(out["wav"].detach(), ref["wav"]) <= 1e-5
    np.testing.assert_allclose(out["commit_losses"].detach().numpy(),
                               np.asarray(ref["commit_losses"]), rtol=1e-5,
                               atol=1e-7)
    for k, v in out["vq_stats"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref["vq_stats"][k]),
                                   atol=1e-5, err_msg=k)


def _codebook(jstate):
    return np.asarray(jstate.params["params"]["quantizer"]["codebook"])


def _assert_ema_state(state, jstate, what):
    np.testing.assert_allclose(state.module.quantizer.codebook.detach(),
                               _codebook(jstate), atol=1e-5,
                               err_msg=f"{what}: codebook")
    np.testing.assert_allclose(state.cluster_size, jstate.cluster_size,
                               atol=1e-5, err_msg=f"{what}: cluster_size")
    np.testing.assert_allclose(state.embed_avg, jstate.embed_avg,
                               atol=1e-5, err_msg=f"{what}: embed_avg")


def test_bootstrap_and_steps_match_jax(codec, jax_run):
    """The k-means bootstrap and two AdamW + EMA steps (dropout, skip and
    dead-code replacement on), every draw JAX's: the metrics within rel
    1e-5, the EMA state within 1e-5, the network parameters by
    ``assert_params_close``. Codes under the threshold after each step
    (cluster_size < 2) take their candidates."""
    jcfg, cfg, jparams, wav, lens = codec
    state, opt = _port_state(cfg, jparams)
    cs.kmeans_bootstrap(cfg, state, wav, np.full((2,), WAV_T),
                        init_idx_override=jax_run["kmeans_idx"])
    _assert_ema_state(state, jax_run["states"][0], "bootstrap")
    step = cs.make_codec_train_step(cfg, opt)
    batch = {"wav": wav, "lengths": lens}
    for n in range(2):
        state, m = step(state, batch, **jax_run["draws"][n])
        want = jax_run["metrics"][n]
        for k in ("loss", "wave_l1", "mel_l1", "commit", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {n}: {k}")
        assert float(m["codebook_usage"]) == want["codebook_usage"]
        assert float(state.cluster_size.min()) < 2.0      # dead codes
        _assert_ema_state(state, jax_run["states"][n + 1], f"step {n}")
    assert state.step == 2
    want = codec_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_run["states"][-1].params), cfg)
    for k, v in state.module.state_dict().items():
        assert_params_close(v.detach().numpy(), want[k].numpy(), lr=LR,
                            err_msg=k)


def test_resumed_step_equals_uninterrupted(codec, tmp_path):
    """Save the state after one step, restore it into a fresh one, take
    the second step: bitwise the uninterrupted second step."""
    jcfg, cfg, jparams, wav, lens = codec
    batch = {"wav": wav, "lengths": lens}
    runs = []
    for resume in (False, True):
        state, opt = _port_state(cfg, jparams)
        step = cs.make_codec_train_step(cfg, opt)
        state, _ = step(state, batch, torch.Generator().manual_seed(0))
        if resume:
            save_train_state(str(tmp_path), state, 1)
            state, opt = _port_state(cfg, jparams)
            restore_train_state(str(tmp_path), 1, state)
            step = cs.make_codec_train_step(cfg, opt)
            assert state.step == 1
        state, m = step(state, batch, torch.Generator().manual_seed(1))
        runs.append((float(m["loss"]), state))
    (l0, s0), (l1, s1) = runs
    assert l0 == l1
    for k, v in s0.module.state_dict().items():
        assert torch.equal(v, s1.module.state_dict()[k]), k
    assert torch.equal(s0.cluster_size, s1.cluster_size)
    assert torch.equal(s0.embed_avg, s1.embed_avg)


# -- the export to the JAX tree ----------------------------------------------

@pytest.mark.parametrize("vocos", [dict(), dict(backbone="resnet"),
                                   dict(adanorm_num_embeddings=2),
                                   dict(head="imdct_symexp",
                                        head_sample_rate=24000)])
def test_codec_state_to_jax_inverts_from_jax(vocos):
    from moss_ttsd_torch.core.config import CodecConfig
    cfg = CodecConfig().tiny()
    cfg = dataclasses.replace(cfg, vocos=dataclasses.replace(cfg.vocos,
                                                             **vocos))
    module = XYTokenizerModule(cfg)
    _init_random(module, 1, "cpu")
    sd = module.state_dict()
    back = codec_state_from_jax(codec_state_to_jax(sd, cfg), cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_exported_tree_round_trips_in_jax(codec):
    """The exported tree has JAX's structure and shapes, and JAX's round
    trip (``__call__``: tokenize, then detokenize) on it gives the port's
    ``forward``: the codes exactly, the wav within 1e-5 of its scale (a
    random codec's wav reaches hundreds)."""
    jcfg, cfg, jparams, wav, lens = codec
    shapes = jax.eval_shape(JModule(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, WAV_T)), jnp.array([WAV_T]))
    assert (jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes)
            == jax.tree_util.tree_map(lambda x: tuple(x.shape), jparams))
    ref = jax.jit(JModule(jcfg).apply)(jparams, jnp.asarray(wav),
                                       jnp.asarray(lens, jnp.int32))
    state, _ = _port_state(cfg, jparams)
    with torch.no_grad():
        got = state.module(_t(wav), _t(lens))
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(ref["codes"]))
    np.testing.assert_array_equal(got["wav_lengths"].numpy(),
                                  np.asarray(ref["wav_lengths"]))
    assert _rel(got["wav"], ref["wav"]) <= 1e-5


# -- data parallel: two gloo processes ------------------------------------------

def test_initialize_multihost_reads_the_jax_environment(tmp_path,
                                                        monkeypatch):
    """JAX's variables name the group: a one-process gloo group here."""
    import torch.distributed as dist
    from moss_ttsd_torch.parallel.distributed import initialize_multihost
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS",
                       "file://" + os.path.join(tmp_path, "store"))
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert initialize_multihost(device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("lengths", [
    [8192, 8192, 8192, 8192], [8192, 6001, 7700, 3000]],
    ids=["full", "unequal"])
def test_data_parallel_step_matches_one_process(lengths, tmp_path):
    """Two ranks of a gloo group (``initialize_multihost`` over a file
    store), two rows each, against one process on the whole batch: loss
    rtol 2e-5, ``cluster_size`` and the codebook atol 1e-4 (JAX's DP
    tolerances), the codebooks identical on both ranks."""
    ctx = multiprocessing.get_context("spawn")
    init = "file://" + os.path.join(tmp_path, "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [ctx.Process(target=tref.run_rank,
                         args=(r, 2, init, outs[r], lengths))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        single = tref.train(lengths)
    finally:
        for p in procs:
            p.join(timeout=120)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not any(alive), "a rank did not exit within 120 s"
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [dict(np.load(o)) for o in outs]
    cb = "param/quantizer.codebook"
    np.testing.assert_array_equal(ranks[0][cb], ranks[1][cb])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], single["loss"], rtol=2e-5)
        np.testing.assert_allclose(r["grad_norm"], single["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["cluster_size"], single["cluster_size"],
                                   atol=1e-4)
        np.testing.assert_allclose(r[cb], single[cb], atol=1e-4)
        for k in ("ema_cluster", "ema_avg", "ema_codebook"):
            np.testing.assert_allclose(r[k], single[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        for k in single:
            if k.startswith("param/") and k != cb:
                assert_params_close(r[k], single[k], lr=tref.LR,
                                    err_msg=k)
