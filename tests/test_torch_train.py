"""The port's LM finetuning step against the JAX package (tiny config, fp32,
CPU, the same weights carried over by ``lm_state_from_jax``): the chunked
multi-channel loss and its gradients, three full-finetune optimizer steps
with remat on and off, exact gradient accumulation, optax's four schedules,
bf16 compute over fp32 masters, and the train-state checkpoint."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.ops import chunked_ce as jce  # noqa: E402
from moss_ttsd_tpu.train import step as jstep  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.models.lm import AsteroidLM  # noqa: E402
from moss_ttsd_torch.ops import chunked_ce as ce  # noqa: E402
from moss_ttsd_torch.train import step as tstep  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import (  # noqa: E402
    lm_state_from_jax, lm_state_to_jax)
from tests.test_torch_lm import jax_tiny  # noqa: E402

IGNORE = -100
LR = 3e-3


def assert_params_close(got, want, lr=LR, err_msg=""):
    """Parameters after a few Adam steps, fp32, across frameworks or
    devices: every element within rtol 1e-4 (atol 1e-6), except at most
    0.1 % of a tensor (or 4 elements), which must be within one update
    (lr). Adam divides each gradient element by its own magnitude, so an
    element whose gradient sits within rounding of zero (|g| near eps =
    1e-8 while its terms are ~1e-4) takes a step that reassociation
    changes; a wrong rule (decay, clip, schedule, moments) moves every
    element."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    outside = err > 1e-4 * np.abs(want) + 1e-6
    assert outside.sum() <= max(4, got.size // 1000), (
        f"{err_msg}: {int(outside.sum())} of {got.size} elements outside "
        f"rtol 1e-4 (largest error {err.max():.3g})")
    assert err.max() <= lr, (
        f"{err_msg}: an element {err.max():.3g} away, more than one update")


def toy_batch(cfg, B=4, T=12, seed=7):
    """Random ids and labels with row-varying -100 masking (micro batches
    then have unequal valid counts) and one right-padded row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.speech_vocab_size, (B, T, cfg.channels))
    ids[..., 0] = rng.integers(0, cfg.vocab_size, (B, T))
    labels = rng.integers(0, cfg.speech_vocab_size, (B, T, cfg.channels))
    labels[..., 0] = rng.integers(0, cfg.vocab_size, (B, T))
    for b in range(B):
        labels[b, : 1 + b] = IGNORE
    mask = np.ones((B, T), np.int64)
    mask[-1, T - 3:] = 0
    labels[-1, T - 3:] = IGNORE
    return {"input_ids": ids, "labels": labels, "attention_mask": mask}


def jax_batch(batch):
    return {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}


def port_model(jcfg, params, **overrides):
    cfg = LMConfig.from_dict({**jcfg.to_dict(), **overrides})
    model = AsteroidLM(cfg)
    model.load_state_dict(lm_state_from_jax(params, cfg))
    return cfg, model


def assert_tree_close(port_sd, jparams, cfg, lr=LR):
    """Every leaf of the port's state dict, exported to JAX's layout,
    against the JAX tree (``assert_params_close``)."""
    got = lm_state_to_jax(port_sd, cfg)["params"]
    want = jax.tree_util.tree_map(np.asarray, jparams)["params"]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict((jax.tree_util.keystr(p), v) for p, v in
                  jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, v in flat_g:
        k = jax.tree_util.keystr(path)
        assert_params_close(v, flat_w[k], lr, k)


# -- the loss -----------------------------------------------------------------

def _loss_inputs(seed=0, B=2, T=13, D=16, V=37, C=4, Vs=11):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, T, D)).astype(np.float32)
    et = (rng.standard_normal((V, D)) * 0.5).astype(np.float32)
    es = (rng.standard_normal((C - 1, Vs, D)) * 0.5).astype(np.float32)
    labels = rng.integers(0, Vs, (B, T, C))
    labels[..., 0] = rng.integers(0, V, (B, T))
    labels[0, :3] = IGNORE
    labels[1, -4:, 2] = IGNORE
    return hidden, labels, et, es


@pytest.mark.parametrize("chunks", [1, 3, 8])
@pytest.mark.parametrize("with_counts", [False, True])
def test_asteroid_loss_and_grads_match_jax(chunks, with_counts):
    """Loss, per-channel losses and the gradients w.r.t. the hidden states
    and both tables against jax.value_and_grad, rtol 1e-5 (B*T = 26 rows:
    padded to the chunk count at 3 and 8)."""
    hidden, labels, et, es = _loss_inputs()
    weights = [8, 2, 1, 1]
    counts = (np.array([30, 20, 11, 25], np.int64) if with_counts else None)

    def jloss(h, t, s):
        return jce.asteroid_loss(
            h, jnp.asarray(labels), t, s, weights, num_chunks=chunks,
            counts=None if counts is None else jnp.asarray(counts))

    (jtotal, jper), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(et), jnp.asarray(es))
    h, t, s = (torch.tensor(a, requires_grad=True) for a in (hidden, et, es))
    total, per = ce.asteroid_loss(
        h, torch.from_numpy(labels), t, s, weights, num_chunks=chunks,
        counts=None if counts is None else torch.from_numpy(counts))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper),
                               rtol=1e-5)
    for got, want in zip((h.grad, t.grad, s.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_chunked_loss_one_chunk_equals_eight():
    hidden, labels, et, es = _loss_inputs(seed=3, B=2, T=16)
    outs = []
    for chunks in (1, 8):
        h, t = (torch.tensor(a, requires_grad=True) for a in (hidden, et))
        total, _ = ce.asteroid_loss(h, torch.from_numpy(labels), t,
                                    torch.from_numpy(es), [8, 2, 1, 1],
                                    num_chunks=chunks)
        total.backward()
        outs.append((float(total.detach()), h.grad, t.grad))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-8)


def test_shift_and_counts_match_jax():
    _, labels, _, _ = _loss_inputs(seed=5)
    np.testing.assert_array_equal(
        ce.shift_for_causal(torch.from_numpy(labels[..., 0])).numpy(),
        np.asarray(jce.shift_for_causal(jnp.asarray(labels[..., 0]))))
    stacked = np.stack([labels, labels[::-1]])            # a (K, B, T, C) axis
    np.testing.assert_array_equal(
        ce.valid_label_counts(torch.from_numpy(stacked)).numpy(),
        np.asarray(jce.valid_label_counts(jnp.asarray(stacked))))


# -- the full-finetune step ----------------------------------------------------

def _jax_run(jcfg, params, batch, steps, remat, accum=1, ce_chunks=2,
             **opt_kw):
    opt = jstep.make_optimizer(**opt_kw)
    state = jstep.init_train_state(jcfg, opt, params=params)
    step = jax.jit(jstep.make_train_step(jcfg, opt, remat=remat,
                                         ce_chunks=ce_chunks,
                                         grad_accum_steps=accum))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        np.asarray(m["loss_per_channel"])))
    return state.params, metrics


def _port_run(cfg, model, batch, steps, remat, accum=1, ce_chunks=2,
              **opt_kw):
    opt = tstep.make_optimizer(**opt_kw)
    state = tstep.init_train_state(cfg, opt, model=model)
    step = tstep.make_train_step(cfg, opt, remat=remat, ce_chunks=ce_chunks,
                                 grad_accum_steps=accum)
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        m["loss_per_channel"].numpy()))
    return state, metrics


OPT = dict(learning_rate=LR, warmup_ratio=0.1, total_steps=10,
           weight_decay=0.01, grad_clip=1.0, lr_scheduler_type="cosine")


@pytest.fixture(scope="module")
def tiny():
    jcfg, params = jax_tiny(3)
    return jcfg, params, toy_batch(jcfg)


@pytest.mark.parametrize("remat", [False, True])
def test_three_full_steps_match_jax(tiny, remat):
    """Three optimizer steps (cosine with one warmup step, so the first
    update has LR 0; weight decay; the clip engaged): losses, grad norms
    and every parameter against JAX make_train_step + make_optimizer."""
    jcfg, params, batch = tiny
    jparams, jm = _jax_run(jcfg, params, jax_batch(batch), 3, remat, **OPT)
    cfg, model = port_model(jcfg, params)
    state, m = _port_run(cfg, model, batch, 3, remat, **OPT)
    for (l, g, per), (jl, jg, jper) in zip(m, jm):
        np.testing.assert_allclose(l, jl, rtol=1e-5)
        np.testing.assert_allclose(g, jg, rtol=1e-5)
        np.testing.assert_allclose(per, jper, rtol=1e-5)
    assert m[0][1] > 1.0            # the clip ran on the first update
    assert_tree_close(state.model.state_dict(), jparams, cfg)
    assert state.step == 3


def test_remat_on_equals_off(tiny):
    """Recomputing each block in the backward changes no number."""
    jcfg, params, batch = tiny
    runs = []
    for remat in (False, True):
        cfg, model = port_model(jcfg, params)
        state, m = _port_run(cfg, model, batch, 2, remat, **OPT)
        runs.append((m, state.model.state_dict()))
    assert [x[:2] for x in runs[0][0]] == [x[:2] for x in runs[1][0]]
    for k, v in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], v, rtol=0, atol=0)


def test_grad_accum_equals_big_batch_and_jax(tiny):
    """K = 2 micro batches of 2 (unequal valid counts) give the B 4 step:
    loss, grad norm and parameters; and JAX's accumulated step."""
    jcfg, params, batch = tiny
    micro = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
    cfg, model = port_model(jcfg, params)
    big_state, big = _port_run(cfg, model, batch, 2, False, **OPT)
    cfg, model = port_model(jcfg, params)
    acc_state, acc = _port_run(cfg, model, micro, 2, False, accum=2, **OPT)
    for (l, g, _), (bl, bg, _) in zip(acc, big):
        np.testing.assert_allclose(l, bl, rtol=1e-6)
        np.testing.assert_allclose(g, bg, rtol=1e-6)
    big_sd = big_state.model.state_dict()
    for k, v in acc_state.model.state_dict().items():
        assert_params_close(v.numpy(), big_sd[k].numpy(), err_msg=k)
    jparams, jm = _jax_run(jcfg, params, jax_batch(micro), 2, False, accum=2,
                           **OPT)
    for (l, g, _), (jl, jg, _) in zip(acc, jm):
        np.testing.assert_allclose(l, jl, rtol=1e-5)
        np.testing.assert_allclose(g, jg, rtol=1e-5)
    assert_tree_close(acc_state.model.state_dict(), jparams, cfg)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant",
                                  "constant_with_warmup"])
@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.25])
def test_schedules_match_optax(kind, ratio):
    """Every update of a 20-step run (and past its end) gets optax's rate,
    to float32 resolution: make_lr_schedule against the JAX package's."""
    lr, total = 3e-4, 20
    mine = tstep.make_lr_schedule(lr, ratio, total, kind)
    theirs = jstep.make_lr_schedule(lr, ratio, total, kind)
    got = np.array([mine(n) for n in range(total + 3)], np.float32)
    want = np.array([float(theirs(jnp.int32(n))) for n in range(total + 3)],
                    np.float32)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=lr * 2e-7)
    if kind in ("cosine", "linear", "constant_with_warmup"):
        assert got[0] == 0.0            # the zero-LR first update
    with pytest.raises(ValueError, match="lr_scheduler_type"):
        tstep.make_lr_schedule(lr, ratio, total, "polynomial")


def test_optimizer_applies_schedule_counts():
    """The optimizer's rate at update n is schedule(n): with a constant
    gradient of one sign, AdamW moves every element by exactly the rate,
    so the first update (cosine warmup, rate 0) moves nothing."""
    opt = tstep.make_optimizer(learning_rate=0.1, warmup_ratio=0.25,
                               total_steps=8, grad_clip=1e9)
    w = torch.zeros(3, requires_grad=True)
    o = opt.init([w])
    seen = []
    for n in range(4):
        before = w.detach().clone()
        w.grad = torch.ones(3)
        opt.update(o, n)
        seen.append(float((before - w.detach())[0]))
    sched = [opt.schedule(n) for n in range(4)]
    np.testing.assert_allclose(seen, sched, rtol=1e-6)
    assert seen[0] == 0.0


def test_clip_matches_optax_and_reports_norm_before_clipping():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    opt = tstep.ClippedAdamW(lambda n: 0.0, grad_clip=1.0)
    ws = [torch.zeros(2, requires_grad=True), torch.zeros(1,
                                                          requires_grad=True)]
    o = opt.init(ws)
    for w, gi in zip(ws, g):
        w.grad = gi.clone()
    norm = opt.update(o, 0)
    assert float(norm) == 13.0
    import optax
    upd, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(x.numpy()) for x in g], optax.EmptyState())
    # the clipped gradients were what AdamW saw: its first moment holds
    # (1 - b1) * clipped g
    for w, u in zip(ws, upd):
        m = o.state[w]["exp_avg"]
        np.testing.assert_allclose(m.numpy(), 0.1 * np.asarray(u),
                                   rtol=1e-6)


def test_bf16_compute_over_fp32_masters(tiny):
    """cfg.dtype bfloat16 with fp32 parameters: the weights stay fp32 (and
    so do their gradients and the Adam moments), the forward runs in bf16
    as flax's casts give it, and the loss agrees with JAX's bf16 step at
    bf16 resolution."""
    jcfg, params, batch = tiny
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    _, jm = _jax_run(jcfg16, params, jax_batch(batch), 2, False, **OPT)
    cfg, model = port_model(jcfg, params, dtype="bfloat16")
    hid, _ = model.backbone(torch.from_numpy(batch["input_ids"]),
                            torch.arange(12).expand(4, 12),
                            torch.ones(4, 12, dtype=torch.bool), None, 0)
    assert hid.dtype == torch.bfloat16
    state, m = _port_run(cfg, model, batch, 2, False, **OPT)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(s["exp_avg"].dtype == torch.float32
               for s in state.optimizer.state.values())
    for (l, g, _), (jl, jg, _) in zip(m, jm):
        np.testing.assert_allclose(l, jl, rtol=2e-2)
        np.testing.assert_allclose(g, jg, rtol=5e-2)


def test_train_state_checkpoint_rotation_and_resume(tiny, tmp_path):
    """save_train_state keeps the ``keep`` newest steps; a state restored
    from step 2 continues exactly as the run that never stopped."""
    from moss_ttsd_torch.core.checkpoint import (latest_step,
                                                 restore_train_state,
                                                 save_train_state)
    jcfg, params, batch = tiny
    ckpt = str(tmp_path / "ckpt")
    opt = tstep.make_optimizer(**OPT)

    def fresh():
        cfg, model = port_model(jcfg, params)
        return cfg, tstep.init_train_state(cfg, opt, model=model)

    cfg, state = fresh()
    step = tstep.make_train_step(cfg, opt, remat=False, ce_chunks=2)
    for n in range(1, 5):
        state, _ = step(state, batch)
        save_train_state(ckpt, state, n, keep=2)
    import os
    assert sorted(os.listdir(ckpt)) == ["step_3", "step_4"]
    assert latest_step(ckpt) == 4
    straight = {k: v.detach().clone() for k, v in state.params.items()}

    _, resumed = fresh()
    resumed = restore_train_state(ckpt, 3, resumed)
    assert resumed.step == 3
    resumed, _ = step(resumed, batch)
    for k, v in resumed.params.items():
        torch.testing.assert_close(v.detach(), straight[k], rtol=0, atol=0)
