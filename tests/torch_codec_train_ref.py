"""The port's codec train step on a tiny codec, as the CPU tests, the GPU
tests and ``chip_smoke.py`` drive it: one process on the CPU or the card
with every draw pinned (``pinned_run``), or one rank of a ``gloo`` process
group (``run_rank``, the target of the data-parallel test's spawned
processes; ``train`` is the same on one process). Imports torch and the
port only, so a spawned process starts without JAX and the card's machine
needs none."""
import dataclasses

import numpy as np
import torch

B, T, STEPS, LR = 4, 8192, 2, 1e-3


def tiny_cfg():
    """``CodecConfig().tiny()`` with quantizer dropout and skip on (the
    dead-code threshold is the default 2.0) and 8 codes a stage, so that
    k-means leaves clusters of several vectors: with one vector a cluster
    every residual past stage 0 is rounding noise, whose nearest code two
    devices may pick apart."""
    from moss_ttsd_torch.core.config import CodecConfig
    cfg = CodecConfig().tiny()
    return dataclasses.replace(cfg, quantizer=dataclasses.replace(
        cfg.quantizer, quantizer_dropout=0.5, skip_rvq_ratio=0.25,
        codebook_size=8))


def _setup(device, seed=3):
    """The tiny codec's train state on ``device``, its weights drawn on the
    CPU from ``seed`` (a card's generator draws other numbers)."""
    from moss_ttsd_torch.models.codec.model import (XYTokenizerModule,
                                                    _init_random)
    from moss_ttsd_torch.train.codec_step import init_codec_train_state
    from moss_ttsd_torch.train.step import make_optimizer
    cfg = tiny_cfg()
    module = XYTokenizerModule(cfg)
    _init_random(module, seed, "cpu")
    opt = make_optimizer(learning_rate=LR, total_steps=10, warmup_ratio=0.0)
    return cfg, opt, init_codec_train_state(
        cfg, opt, params=module.state_dict(), device=device)


def _result(state, metrics) -> dict:
    out = {k: np.asarray(v) for k, v in metrics.items()}
    out["cluster_size"] = state.cluster_size.cpu().numpy()
    out["embed_avg"] = state.embed_avg.cpu().numpy()
    for k, v in state.params.items():
        out["param/" + k] = v.detach().cpu().numpy()
    return out


def train(lengths, group=None):
    """``STEPS`` steps on the global batch (B x T, ``lengths``) of seed 19,
    from the weights of seed 3 and a generator of seed 0; under ``group``
    this rank's rows. Returns numpy: the metrics a step, the EMA state, the
    parameters and one ``ema_update`` over the group."""
    from moss_ttsd_torch.models.codec.rvq import ema_update
    from moss_ttsd_torch.train.codec_step import make_codec_train_step
    cfg, opt, state = _setup("cpu")
    wav = (np.random.default_rng(19).standard_normal((B, T)) * 0.1
           ).astype(np.float32)
    lengths = np.asarray(lengths, np.int64)
    rows = slice(0, B)
    if group is not None:
        world = torch.distributed.get_world_size(group)
        rank = torch.distributed.get_rank(group)
        rows = slice(rank * B // world, (rank + 1) * B // world)
    step = make_codec_train_step(cfg, opt, group=group)
    gen = torch.Generator().manual_seed(0)
    metrics = {}
    for _ in range(STEPS):
        state, m = step(state, {"wav": wav[rows], "lengths": lengths[rows]},
                        gen)
        for k, v in m.items():
            metrics.setdefault(k, []).append(float(v))
    out = _result(state, metrics)
    # the per-stage EMA update, its statistics summed over the group
    g = np.random.default_rng(5)
    enc = torch.from_numpy(g.standard_normal((B * 6, 16)).astype(np.float32))
    idx = torch.from_numpy(g.integers(0, 64, B * 6))
    cb = torch.from_numpy(g.standard_normal((64, 16)).astype(np.float32))
    part = slice(rows.start * 6, rows.stop * 6)
    ema = ema_update(torch.zeros(64), cb.clone(), cb, enc[part], idx[part],
                     group=group)
    for k, v in zip(("ema_cluster", "ema_avg", "ema_codebook"), ema):
        out[k] = v.numpy()
    return out


def run_rank(rank: int, world: int, init_method: str, out_path: str,
             lengths) -> None:
    import torch.distributed as dist
    from moss_ttsd_torch.parallel.distributed import initialize_multihost
    torch.set_num_threads(1)
    if not initialize_multihost(init_method, world, rank, device="cpu"):
        raise RuntimeError("no process group")
    try:
        np.savez(out_path, **train(lengths, dist.group.WORLD))
    finally:
        dist.destroy_process_group()


def pinned_run(device, samples: int = 48000, steps: int = 2) -> dict:
    """The k-means bootstrap and ``steps`` steps on ``device`` from the
    weights of seed 3, on a batch of 2 x ``samples`` (a padded row), with
    every draw made beforehand on the CPU (seed 0) and passed as an
    override: the same run on any device. Returns numpy, as ``train``."""
    from moss_ttsd_torch.train.codec_step import (kmeans_bootstrap,
                                                  make_codec_train_step)
    cfg, opt, state = _setup(device)
    qc = cfg.quantizer
    wav = (np.random.default_rng(17).standard_normal((2, samples)) * 0.1
           ).astype(np.float32)
    lengths = np.array([samples, samples - samples // 6], np.int64)
    codes = -(-(samples // 160 // 2) // 4)
    gen = torch.Generator().manual_seed(0)
    rvq = state.module.quantizer
    kmeans_bootstrap(cfg, state, wav, np.full((2,), samples),
                     init_idx_override=torch.stack([
                         torch.randperm(2 * codes, generator=gen)[
                             :qc.codebook_size]
                         for _ in range(qc.num_quantizers)]))
    step = make_codec_train_step(cfg, opt)
    metrics = {}
    for _ in range(steps):
        n_active, skip = rvq.draw_dropout_and_skip(2, gen, "cpu")
        state, m = step(state, {"wav": wav, "lengths": lengths},
                        n_active_override=n_active, skip_override=skip,
                        sample_idx_override=rvq.draw_sample_idx(
                            skip, codes, gen))
        for k, v in m.items():
            metrics.setdefault(k, []).append(float(v))
    return _result(state, metrics)
