"""Sequence-parallel LM finetuning of the port on the CPU: spawned gloo
ranks (``tests/torch_mesh_ref.py``) on ("data", "seq") meshes (1, 2) and
(2, 2), against the JAX step on one device (``make_train_step``; JAX's
``hidden_sharding=P("data", "seq")`` step equals it,
``tests/test_train.py``): 3 steps at accumulation 1 and 2, remat on and
off, on a batch with a left-padded row and a row whose labels are all
masked. Losses and grad norms to rel 1e-5, the trained tensors by
``assert_params_close``, and the K/V gathers a step (remat gathers again
in the backward). Then the finetune CLI: ``sequence_parallel: 2`` over
data 2 x seq 2 against plain data parallelism over 4 ranks at the same
global batch. The mesh helpers (``seq_spec``, ``SequenceParallel``) in one
process."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ref as R  # noqa: E402
from moss_ttsd_tpu.train import step as jstep  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import lm_state_from_jax  # noqa: E402
from tests.test_torch_finetune_cli import (_config, _load_port,  # noqa: E402
                                           tiny_data)  # noqa: F401
from tests.test_torch_lm import jax_tiny  # noqa: E402
from tests.test_torch_train import assert_params_close  # noqa: E402

REL = 1e-5
B, T = 4, 16
# (name, data, seq, K, remat)
CASES2 = [("sp1x2_k1", 1, 2, 1, False), ("sp1x2_k2_remat", 1, 2, 2, True)]
CASES4 = [("sp2x2_k1_remat", 2, 2, 1, True), ("sp2x2_k2", 2, 2, 2, False)]
CASES = CASES2 + CASES4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX weights and a global batch of 4 rows of T 16: row 0 left-padded
    by 5, row 2's labels all -100, the others masked over a prefix."""
    jcfg, params = jax_tiny(6)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 30, (B, T, cfg.channels))
    ids[..., 0] = rng.integers(0, cfg.vocab_size, (B, T))
    labels = rng.integers(0, 30, (B, T, cfg.channels))
    labels[..., 0] = rng.integers(0, cfg.vocab_size, (B, T))
    mask = np.ones((B, T), np.int64)
    mask[0, :5] = 0
    labels[0, :7] = -100
    labels[1, :3] = -100
    labels[2] = -100
    labels[3, :9, 1] = -100
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask}
    tmp = tmp_path_factory.mktemp("sp")
    inp = str(tmp / "inputs.pt")
    torch.save({"cfg": cfg.to_dict(), "state": lm_state_from_jax(params, cfg),
                "train_batch": batch}, inp)
    return jcfg, cfg, params, batch, tmp, inp


@pytest.fixture(scope="module")
def ranks(setup):
    """Every case's result on every rank: two spawned groups (2 and 4)."""
    *_, tmp, inp = setup
    out = {}
    for world, cases in ((2, CASES2), (4, CASES4)):
        res = R.spawn(world, R.sp_train_cases, str(tmp / f"w{world}"), inp,
                      cases)
        for name, *_ in cases:
            out[name] = [r[name] for r in res]
    return out


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX step on one device, 3 steps at K 1 and 2."""
    jcfg, cfg, params, batch, *_ = setup
    out = {}
    for K in (1, 2):
        opt = jstep.make_optimizer(learning_rate=R.LR, total_steps=10,
                                   warmup_ratio=0.0,
                                   lr_scheduler_type="constant")
        state = jstep.init_train_state(jcfg, opt, params=params)
        step = jax.jit(jstep.make_train_step(jcfg, opt, remat=False,
                                             ce_chunks=2,
                                             grad_accum_steps=K))
        jb = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
        if K > 1:
            jb = jax.tree.map(lambda x: x.reshape((K, -1) + x.shape[1:]), jb)
        losses, norms = [], []
        for _ in range(R.TRAIN_STEPS):
            state, m = step(state, jb)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[K] = {"loss": np.array(losses), "grad_norm": np.array(norms),
                  "per_channel": np.asarray(m["loss_per_channel"]),
                  "params": lm_state_from_jax(
                      jax.tree.map(np.asarray, state.params), cfg)}
    return out


@pytest.mark.parametrize("name,data,seq,K,remat", CASES,
                         ids=[c[0] for c in CASES])
def test_sp_step_matches_jax(ranks, jax_runs, setup, name, data, seq, K,
                             remat):
    """Every rank reports the JAX step's loss, per-channel loss and grad
    norm over 3 steps, and holds its trained tensors; each layer gathers
    K and V once a micro batch in the forward, sums their cotangents once
    in the backward, and under remat gathers them again there."""
    cfg = setup[1]
    want = jax_runs[K]
    for got in ranks[name]:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=REL)
        np.testing.assert_allclose(got["per_channel"], want["per_channel"],
                                   rtol=REL, atol=1e-7)
        assert set(got["params"]) == set(want["params"])
        for k, v in want["params"].items():
            assert_params_close(got["params"][k], v.numpy(), lr=R.LR,
                                err_msg=f"{name} {k}")
        per_layer = 4 + (2 if remat else 0)
        assert got["gathers_per_step"] == K * cfg.num_hidden_layers * \
            per_layer


def test_seq_shard_on_the_ranks(ranks):
    """On a (data, seq) mesh each rank's ``seq_spec`` and its
    ``SequenceParallel.shard`` of a (1, T) leaf are its window, in rank
    order over the seq ranks (data major); a leaf with no time axis stays
    whole (no spec wider than the leaf, as in JAX)."""
    for name, data, seq, *_ in CASES:
        got = [r["shard"] for r in ranks[name]]
        for rank, (row, flat, spec) in enumerate(got):
            r = rank % seq
            assert spec == slice(r * T // seq, (r + 1) * T // seq)
            assert row.tolist() == [list(range(spec.start, spec.stop))]
            assert flat.tolist() == [0, 1, 2]


def test_seq_spec_and_shard(tmp_path):
    """``SequenceParallel.window`` gives rank r its [r T/sp, (r+1) T/sp)
    and refuses a T it does not divide; a one-process mesh has no seq
    axis: ``seq_spec`` keeps the whole time axis, and a seq axis the
    group cannot hold is refused. (A seq axis:
    ``test_seq_shard_on_the_ranks``.)"""
    import torch.distributed as dist
    from moss_ttsd_torch.parallel.distributed import initialize_multihost
    from moss_ttsd_torch.parallel.mesh import (SequenceParallel, make_mesh,
                                               seq_spec)
    assert [SequenceParallel(r, 4).window(64) for r in range(4)] == [
        slice(0, 16), slice(16, 32), slice(32, 48), slice(48, 64)]
    with pytest.raises(ValueError, match="does not split"):
        SequenceParallel(0, 3).window(64)
    assert initialize_multihost("file://" + str(tmp_path / "store"), 1, 0,
                                device="cpu")
    try:
        mesh = make_mesh(device_type="cpu")
        assert (mesh.seq, mesh.seq_rank, mesh.sequence_parallel()) == (
            1, 0, None)
        assert seq_spec(mesh, 48) == slice(0, 48)
        assert mesh.train_group is mesh.data_group
        with pytest.raises(ValueError, match="mesh != 1 processes"):
            make_mesh(1, 1, seq=2, device_type="cpu")
    finally:
        dist.destroy_process_group()


# -- the finetune CLI --------------------------------------------------------------

def assert_weights_close(a_npz, b_npz, lr, atol=2e-6):
    """Two CLI runs' model.npz: every element within ``atol`` (the JAX
    CLI tests' bar), except at most max(4, n/1000) elements a tensor,
    each within one update (``lr``): Adam steps an element whose gradient
    is within rounding of zero by up to lr in either direction, and a
    different reduction order moves that rounding (ROADMAP C, "Adam steps
    across frameworks or devices")."""
    x, y = _load_port(a_npz), _load_port(b_npz)
    for (k, v), w in zip(x.state_dict().items(), y.state_dict().values()):
        err = (w - v).abs()
        outside = int((err > atol).sum())
        assert outside <= max(4, v.numel() // 1000), (
            f"{k}: {outside} of {v.numel()} elements beyond atol {atol} "
            f"(largest {float(err.max()):.3g})")
        assert float(err.max()) <= lr, f"{k}: {float(err.max()):.3g} > {lr}"


def test_finetune_cli_sequence_parallel_matches_dp(tiny_data, tmp_path):
    """4 ranks: data 4 x seq 1 at per-device 2 against data 2 x seq 2 at
    per-device 4 (8 rows a step either way, K 2, lr 1e-3), 3 steps: the
    same model.npz (``assert_weights_close``)."""
    base = open(_config(tmp_path, sched="constant")).read()
    dp, sp = tmp_path / "dp.yaml", tmp_path / "sp.yaml"
    dp.write_text(base)
    sp.write_text(base.replace("per_device_train_batch_size: 2",
                               "per_device_train_batch_size: 4")
                  + "sequence_parallel: 2\n")
    a, b = str(tmp_path / "dp"), str(tmp_path / "sp")
    for cfg, out in ((dp, a), (sp, b)):
        R.launch_finetune(4, "--data_dir", tiny_data, "--output_dir", out,
                          "--training_config", str(cfg), "--max_steps", "3")
    assert_weights_close(os.path.join(a, "model.npz"),
                         os.path.join(b, "model.npz"), lr=1e-3)
