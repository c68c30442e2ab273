"""The port's LoRA finetuning against the JAX package (tiny config, fp32,
CPU, the same base weights and factors carried over by
``lm_state_from_jax``): three layerwise LoRA steps (the finetune CLI's
path), ``fold_lora_tree``, a ``lora_targets`` subset, exact accumulation,
the merge-based step and ``merge_lora``, and the JAX-layout export of a
LoRA model read back by JAX's forward."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.models import lm as jlm  # noqa: E402
from moss_ttsd_tpu.train import lora as jlora  # noqa: E402
from moss_ttsd_tpu.train import step as jstep  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.models.lm import AsteroidLM  # noqa: E402
from moss_ttsd_torch.train import lora as tlora  # noqa: E402
from moss_ttsd_torch.train import step as tstep  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import (  # noqa: E402
    lm_state_from_jax, lm_state_to_jax)
from tests.test_torch_lm import jax_tiny  # noqa: E402
from tests.test_torch_train import (OPT, assert_params_close,  # noqa: E402
                                    assert_tree_close, jax_batch, toy_batch)

RANK, ALPHA = 4, 8.0


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_b(trainable, seed):
    """Replace the zero lora_b leaves by N(0, 0.02) draws, so the delta
    is live from the first forward."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (jnp.asarray(rng.standard_normal(v.shape)
                                  .astype(np.float32) * 0.02)
                      if p[-1].key == "lora_b" else v), trainable)


def jax_lora(seed=3, targets=None, random_b=True):
    jcfg, params = jax_tiny(seed)
    over = {"lora_rank": RANK, "lora_alpha": ALPHA}
    if targets:
        over["lora_targets"] = targets
    lcfg = dataclasses.replace(jcfg, **over)
    frozen, trainable = jlora.split_lora_tree(
        jlora.graft_lora_params(params, lcfg, jax.random.PRNGKey(1)))
    if random_b:
        trainable = _random_b(trainable, seed)
    return lcfg, frozen, trainable


def port_lora(lcfg, frozen, trainable):
    cfg = LMConfig.from_dict(lcfg.to_dict())
    model = AsteroidLM(cfg)
    model.load_state_dict(lm_state_from_jax(
        _np_tree(jlora.merge_lora_tree(frozen, trainable)), cfg))
    return cfg, model


def _jax_steps(lcfg, frozen, trainable, batch, n, remat=False, accum=1):
    opt = jstep.make_optimizer(**OPT)
    st = jstep.TrainState(jnp.zeros((), jnp.int32), trainable,
                          opt.init(trainable))
    step = jax.jit(jlora.make_layerwise_lora_step(
        lcfg, opt, remat=remat, ce_chunks=2, grad_accum_steps=accum))
    ms = []
    for _ in range(n):
        st, m = step(st, batch, frozen)
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    return st.params, ms


def _port_steps(cfg, model, batch, n, remat=False, accum=1):
    opt = tstep.make_optimizer(**OPT)
    st = tlora.init_lora_state(model, opt)
    step = tlora.make_layerwise_lora_step(cfg, opt, remat=remat, ce_chunks=2,
                                          grad_accum_steps=accum)
    ms = []
    for _ in range(n):
        st, m = step(st, batch)
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    return st, ms


@pytest.mark.parametrize("remat", [False, True])
def test_three_layerwise_lora_steps_match_jax(remat):
    """Losses, grad norms and every factor against JAX
    make_layerwise_lora_step; the optimizer holds the factors alone and
    the base weights stay bitwise as they were."""
    lcfg, frozen, trainable = jax_lora()
    batch = toy_batch(lcfg)
    jparams, jm = _jax_steps(lcfg, frozen, trainable, jax_batch(batch), 3,
                             remat)
    cfg, model = port_lora(lcfg, frozen, trainable)
    base_before = {k: v.clone() for k, v in model.state_dict().items()
                   if "lora_" not in k}
    st, m = _port_steps(cfg, model, batch, 3, remat)
    for (l, g), (jl, jg) in zip(m, jm):
        np.testing.assert_allclose(l, jl, rtol=1e-5)
        np.testing.assert_allclose(g, jg, rtol=1e-5)
    n_factors = 2 * len(cfg.lora_targets) * cfg.num_hidden_layers
    assert len(st.params) == n_factors
    assert sum(len(g["params"]) for g in st.optimizer.param_groups) == n_factors
    assert_tree_close(st.params, jparams, cfg)
    for k, v in model.state_dict().items():
        if "lora_" not in k:
            assert torch.equal(v, base_before[k]), k
            assert not dict(model.named_parameters())[k].requires_grad


def test_layerwise_lora_from_zero_b_trains_b_first():
    """The graft's init (lora_b zeros): the first update moves only b, and
    b is non-zero after it; JAX agrees on the factors after two steps."""
    lcfg, frozen, trainable = jax_lora(random_b=False)
    batch = toy_batch(lcfg)
    cfg, model = port_lora(lcfg, frozen, trainable)
    a0 = {k: v.clone() for k, v in model.state_dict().items()
          if k.endswith("lora_a")}
    opt = tstep.make_optimizer(learning_rate=1e-3, lr_scheduler_type="constant")
    st = tlora.init_lora_state(model, opt)
    step = tlora.make_layerwise_lora_step(cfg, opt, remat=True, ce_chunks=2)
    st, _ = step(st, batch)
    for k, v in st.params.items():
        if k.endswith("lora_a"):
            assert torch.equal(v.detach(), a0[k])
        else:
            assert float(v.detach().abs().max()) > 0, k


def test_fold_lora_tree_matches_jax():
    lcfg, frozen, trainable = jax_lora(seed=5)
    cfg, model = port_lora(lcfg, frozen, trainable)
    folded = tlora.fold_lora_tree(model.state_dict(), cfg)
    assert not any("lora_" in k for k in folded)
    jfolded = _np_tree(jlora.fold_lora_tree(
        jlora.merge_lora_tree(frozen, trainable), lcfg))
    got = lm_state_to_jax(folded, cfg)["params"]
    for path, v in jax.tree_util.tree_flatten_with_path(got)[0]:
        want = jfolded["params"]
        for k in path:
            want = want[k.key]
        np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    # the folded plain model computes the LoRA model's function
    plain = AsteroidLM(dataclasses.replace(cfg, lora_rank=0))
    plain.load_state_dict(folded)
    ids = torch.from_numpy(toy_batch(cfg)["input_ids"])
    with torch.no_grad():
        np.testing.assert_allclose(plain(ids)[0].numpy(), model(ids)[0].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_lora_targets_subset_matches_jax():
    """cfg.lora_targets limits the adapters to q_proj and v_proj, and the
    step over them agrees with JAX's."""
    lcfg, frozen, trainable = jax_lora(seed=6, targets=("q_proj", "v_proj"))
    cfg, model = port_lora(lcfg, frozen, trainable)
    names = {k.split(".")[2] for k, _ in model.named_parameters()
             if "lora_" in k}
    assert names == {"q_proj", "v_proj"}
    batch = toy_batch(lcfg, seed=9)
    jparams, jm = _jax_steps(lcfg, frozen, trainable, jax_batch(batch), 2)
    st, m = _port_steps(cfg, model, batch, 2)
    for (l, g), (jl, jg) in zip(m, jm):
        np.testing.assert_allclose(l, jl, rtol=1e-5)
        np.testing.assert_allclose(g, jg, rtol=1e-5)
    assert_tree_close(st.params, jparams, cfg)


def test_layerwise_lora_accum_equals_big_batch_and_jax():
    lcfg, frozen, trainable = jax_lora(seed=8)
    batch = toy_batch(lcfg, seed=11)
    micro = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
    cfg, model = port_lora(lcfg, frozen, trainable)
    big, mb = _port_steps(cfg, model, batch, 2)
    cfg, model = port_lora(lcfg, frozen, trainable)
    acc, ma = _port_steps(cfg, model, micro, 2, accum=2)
    for (l, g), (bl, bg) in zip(ma, mb):
        np.testing.assert_allclose(l, bl, rtol=1e-6)
        np.testing.assert_allclose(g, bg, rtol=1e-6)
    for k, v in acc.params.items():
        assert_params_close(v.detach().numpy(),
                            big.params[k].detach().numpy(), err_msg=k)
    jparams, jm = _jax_steps(lcfg, frozen, trainable, jax_batch(micro), 2,
                             accum=2)
    for (l, g), (jl, jg) in zip(ma, jm):
        np.testing.assert_allclose(l, jl, rtol=1e-5)
    assert_tree_close(acc.params, jparams, cfg)


def test_lora_remat_on_equals_off():
    """Blocks recomputed in the backward with a frozen input still give
    the factors inside them their gradients (non-reentrant checkpoint)."""
    lcfg, frozen, trainable = jax_lora(seed=4)
    batch = toy_batch(lcfg)
    runs = []
    for remat in (False, True):
        cfg, model = port_lora(lcfg, frozen, trainable)
        st, m = _port_steps(cfg, model, batch, 2, remat)
        runs.append((m, {k: v.detach() for k, v in st.params.items()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def _to_port_lora(jl, L):
    """JAX init_lora's {".../<t>/kernel": {"a" (L, in, r), "b"}} -> the
    port's {"layers.<l>.<t>.weight": {"a" (in, r), "b" (r, out)}}."""
    out = {}
    for key, fac in jl.items():
        t = key.split("/")[-2]
        for l in range(L):
            out[f"layers.{l}.{t}.weight"] = {
                "a": torch.from_numpy(np.array(fac["a"][l])),
                "b": torch.from_numpy(np.array(fac["b"][l]))}
    return out


def test_merge_based_lora_step_and_merge_match_jax():
    """init_lora's layout, apply_lora / merge_lora and two steps of the
    merge-based make_lora_train_step against JAX's."""
    jcfg, params = jax_tiny(2)
    L = jcfg.num_hidden_layers
    jl = jlora.init_lora(params, jax.random.PRNGKey(1), rank=RANK)
    rng = np.random.default_rng(0)
    jl = {k: {"a": v["a"], "b": jnp.asarray(
        rng.standard_normal(v["b"].shape).astype(np.float32) * 0.02)}
        for k, v in jl.items()}
    cfg = LMConfig.from_dict(jcfg.to_dict())
    base = AsteroidLM(cfg)
    base.load_state_dict(lm_state_from_jax(params, cfg))
    base.requires_grad_(False)
    pl = _to_port_lora(jl, L)
    mine = tlora.init_lora(base.state_dict(), rank=RANK)
    assert set(mine) == set(pl)
    assert all(mine[k]["a"].shape == pl[k]["a"].shape
               and mine[k]["b"].shape == pl[k]["b"].shape
               and not mine[k]["b"].any() for k in mine)

    merged = tlora.merge_lora(base.state_dict(), pl, RANK, ALPHA)
    jmerged = _np_tree(jlora.merge_lora(params, jl, RANK, ALPHA))
    got = lm_state_to_jax(merged, cfg)["params"]["layers"]["block"]
    for t in ("q_proj", "down_proj"):
        np.testing.assert_allclose(got[t]["kernel"],
                                   jmerged["params"]["layers"]["block"][t]
                                   ["kernel"], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="rank"):
        tlora.apply_lora(base.state_dict(), pl, RANK + 1, ALPHA)

    batch = toy_batch(jcfg)
    opt = jstep.make_optimizer(**OPT)
    jst = jstep.TrainState(jnp.zeros((), jnp.int32), jl, opt.init(jl))
    jstep_fn = jax.jit(jlora.make_lora_train_step(
        jcfg, opt, rank=RANK, alpha=ALPHA, remat=False, ce_chunks=2))
    topt = tstep.make_optimizer(**OPT)
    st = tlora.lora_state(pl, topt)
    step = tlora.make_lora_train_step(cfg, topt, base_params=base, rank=RANK,
                                      alpha=ALPHA, remat=True, ce_chunks=2)
    for _ in range(2):
        jst, jm = jstep_fn(jst, jax_batch(batch), params)
        st, m = step(st, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    want = _to_port_lora(jst.params, L)
    for key, fac in tlora.lora_tree(st.params).items():
        for ab in ("a", "b"):
            assert_params_close(fac[ab].detach().numpy(),
                                want[key][ab].numpy(), err_msg=key + ab)


def test_lm_state_to_jax_roundtrip_and_jax_forward():
    """A LoRA model's state dict exported to JAX's layout gives JAX's
    LoRA model the port's logits, and comes back unchanged through
    lm_state_from_jax."""
    lcfg, frozen, trainable = jax_lora(seed=9)
    cfg, model = port_lora(lcfg, frozen, trainable)
    tree = lm_state_to_jax(model.state_dict(), cfg)
    back = lm_state_from_jax(tree, cfg)
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    ids = toy_batch(cfg)["input_ids"]
    jt, js = jlm.AsteroidLM(lcfg).apply(jax.tree_util.tree_map(jnp.asarray,
                                                               tree),
                                        jnp.asarray(ids))
    with torch.no_grad():
        pt, ps = model(torch.from_numpy(ids))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-4)
