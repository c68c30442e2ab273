"""Residual vector quantizer: PyTorch port of
``moss_ttsd_tpu/models/codec/rvq.py`` (``nearest_codes``, the inference
``ResidualVQ.__call__`` and ``ResidualVQ.decode`` with the folded input and
output projections; the train mode ``train_call`` and ``kmeans_init_call``;
the EMA codebook functions ``ema_update``, ``ema_update_stacked``,
``replace_dead_codes`` and ``kmeans_init``).

The module stays pure, as in the JAX package: ``train_call`` returns the
per-stage batch statistics and ``train/codec_step.py`` applies the EMA
update to the codebook parameter. Random draws come from an explicit
``torch.Generator`` (torch's Philox draws differently from JAX's threefry)
or from overrides that pin them. Under a ``torch.distributed`` process
group the draws are made over the global batch from a generator seeded
alike on every rank, each rank takes its own rows, and the statistics are
``all_reduce``d: the counterpart of the JAX package's GSPMD sums and
``psum``.

All in fp32: the quantizer subtree keeps fp32 weights even when the rest of
the codec runs in bf16. The codebook distances are a matmul whose argmin
picks the code, so a near tie flips with the matmul's precision: on the card
it must run in true fp32, which is PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32`` False); a caller that turns TF32
on changes the codes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import RVQConfig


def nearest_codes(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """L2-nearest codebook index of each vector: z_e (..., D), codebook
    (K, D) -> (...,) int64. ||z||^2 is constant per row and dropped; ties
    go to the first index, as jnp.argmin."""
    z = z_e.to(torch.float32)
    cb = codebook.to(torch.float32)
    dist = -2.0 * (z @ cb.T) + torch.sum(cb * cb, dim=-1)[None, :]
    return torch.argmin(dist.reshape(-1, cb.shape[0]), dim=-1).reshape(
        z_e.shape[:-1])


class ResidualVQ(nn.Module):
    """Codebooks (nq, K, D) + the folded WNConv1d(k=1) input and output
    projections."""

    def __init__(self, cfg: RVQConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.input_dim != cfg.rvq_dim:
            self.input_proj = nn.Linear(cfg.input_dim, cfg.rvq_dim)
        if cfg.rvq_dim != cfg.output_dim:
            self.output_proj = nn.Linear(cfg.rvq_dim, cfg.output_dim)
        self.codebook = nn.Parameter(
            torch.empty(cfg.num_quantizers, cfg.codebook_size,
                        cfg.codebook_dim))

    def _project_in(self, z: torch.Tensor) -> torch.Tensor:
        if self.cfg.input_dim != self.cfg.rvq_dim:
            z = self.input_proj(z)
        return z.to(torch.float32)

    def _project_out(self, out: torch.Tensor) -> torch.Tensor:
        if self.cfg.rvq_dim != self.cfg.output_dim:
            out = self.output_proj(out)
        return out

    def forward(self, z: torch.Tensor, lengths: torch.Tensor):
        """Inference quantize of z (B, T, input_dim) -> (zq (B, T,
        output_dim), codes (nq, B, T), lengths). Each stage quantizes the
        masked residual (padding frames are 0) and subtracts its pick; the
        straight-through sum ``r + (q - r)`` of the JAX code is kept as
        written, since its rounding feeds the next stage's residual."""
        z = self._project_in(z)
        T = z.shape[1]
        mask = (torch.arange(T, device=z.device)[None, :]
                < lengths[:, None])[..., None]                  # (B, T, 1)
        zero = torch.zeros((), dtype=z.dtype, device=z.device)
        quantized = torch.zeros_like(z)
        residual = z
        codes = []
        for cb in self.codebook:
            masked = torch.where(mask, residual, zero)
            idx = nearest_codes(masked, cb)
            z_q = masked + (cb[idx] - masked)
            z_q = torch.where(mask, z_q, zero)
            quantized = quantized + z_q
            residual = residual - z_q
            codes.append(idx)
        return self._project_out(quantized), torch.stack(codes), lengths

    def train_call(self, z: torch.Tensor, lengths: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   n_active_override: Optional[torch.Tensor] = None,
                   skip_override: Optional[torch.Tensor] = None,
                   sample_idx_override: Optional[torch.Tensor] = None,
                   group=None):
        """Training-mode forward: quantizer dropout, the skip-rvq
        straight-through bypass and the per-stage EMA batch statistics.

        Returns (zq, codes (nq, B, T), commits (nq,), lengths, stats) with
        stats = {"cluster_new": (nq, K), "embed_sum": (nq, K, D),
        "samples": (nq, K, D)}.

        The draws cover the global batch of G rows (G = B x world size under
        ``group``, rows [rank B, rank B + B) this rank's): ``n_active`` (G,)
        float, ``skip`` (G,) bool and the dead-code candidates'
        ``sample_idx`` (nq, K) into the G x T flattened encodings. Each
        override replaces its draw; what is not overridden is drawn from
        ``generator`` (the same seed on every rank) in that order. Under
        ``group`` the per-stage commit of each rank is its share of the
        global one (local sum over the global count of dropout-active rows)
        and ``stats`` are global sums, equal on every rank."""
        c = self.cfg
        nq, K = c.num_quantizers, c.codebook_size
        z = self._project_in(z)
        codebook = self.codebook
        B, T, _ = z.shape
        dev = z.device
        world, rank = _world(group)
        G = B * world
        rows = slice(rank * B, rank * B + B)
        mask = (torch.arange(T, device=dev)[None, :]
                < lengths[:, None])[..., None]                  # (B, T, 1)

        n_active, skip = self.draw_dropout_and_skip(
            G, generator, dev, n_active_override, skip_override)
        if sample_idx_override is not None:
            sample_idx = sample_idx_override.to(device=dev, dtype=torch.long)
        else:
            sample_idx = self.draw_sample_idx(skip, T, generator).to(dev)
        skipped = skip[rows]
        notskip = (~skipped).to(torch.float32)

        zero = torch.zeros((), dtype=z.dtype, device=dev)
        quantized = torch.zeros_like(z)
        residual = z
        codes, commits, encs = [], [], []
        cluster_new, embed_sum = [], []
        for i in range(nq):
            masked = torch.where(mask, residual, zero)
            idx = nearest_codes(masked, codebook[i])             # (B, T)
            picked = codebook[i][idx].detach()
            commit = ((masked - picked) ** 2).mean(dim=(1, 2)) * c.commitment
            z_q = masked + (picked - masked).detach()
            # skip bypass: output := input, zero commit, zero index
            z_q = torch.where(skipped[:, None, None], masked, z_q)
            commit = torch.where(skipped, zero, commit)
            idx = torch.where(skipped[:, None], torch.zeros_like(idx), idx)

            active = (i < n_active).to(torch.float32)            # (G,)
            q = active[rows]                                     # (B,)
            update = mask & (q > 0)[:, None, None]
            quantized = quantized + torch.where(update, z_q, zero)
            residual = residual - torch.where(update, z_q, zero)

            # per-stage commit averaged over the dropout-active rows of the
            # global batch
            denom = active.sum()
            commits.append(torch.where(
                denom > 0, (commit * q).sum() / denom.clamp_min(1.0), zero))
            codes.append(idx)

            # EMA statistics over the non-skipped rows; dropout-gated rows
            # still contribute their (frozen) residual
            enc = masked.detach()
            onehot = F.one_hot(idx, K).to(torch.float32) \
                * notskip[:, None, None]                         # (B, T, K)
            cluster_new.append(onehot.sum(dim=(0, 1)))
            embed_sum.append(torch.einsum("btd,btk->kd", enc, onehot))
            encs.append(enc.reshape(B * T, -1))

        cluster_new = _all_reduce(torch.stack(cluster_new), group)
        embed_sum = _all_reduce(torch.stack(embed_sum), group)
        flat = torch.stack(encs)                                 # (nq, BT, D)
        if group is not None:
            parts = [torch.empty_like(flat) for _ in range(world)]
            torch.distributed.all_gather(parts, flat.contiguous(),
                                         group=group)
            flat = torch.cat(parts, dim=1)                       # (nq, GT, D)
        samples = torch.gather(
            flat, 1, sample_idx[..., None].expand(-1, -1, flat.shape[-1]))
        stats = {"cluster_new": cluster_new, "embed_sum": embed_sum,
                 "samples": samples}
        return (self._project_out(quantized), torch.stack(codes),
                torch.stack(commits), lengths, stats)

    def draw_dropout_and_skip(self, G: int, generator, device,
                              n_active_override=None, skip_override=None):
        """The global batch's dropout counts (G,) float and skip mask (G,)
        bool: the first int(G x quantizer_dropout) rows draw an active-stage
        count in [1, nq], the rest use every stage (nq + 1); a row is
        skipped with probability skip_rvq_ratio, and if every row is, row 0
        is not."""
        c = self.cfg
        nq = c.num_quantizers
        if n_active_override is not None:
            n_active = n_active_override.to(device=device,
                                            dtype=torch.float32)
        else:
            n_active = torch.full((G,), float(nq + 1), device=device)
            n_dropout = int(G * c.quantizer_dropout)
            if n_dropout > 0:
                drawn = torch.randint(1, nq + 1, (G,), generator=generator,
                                      device=_gen_device(generator))
                n_active[:n_dropout] = drawn[:n_dropout].to(device,
                                                            torch.float32)
        if skip_override is not None:
            skip = skip_override.to(device=device, dtype=torch.bool)
        elif c.skip_rvq_ratio > 0:
            skip = (torch.rand((G,), generator=generator,
                               device=_gen_device(generator))
                    < c.skip_rvq_ratio).to(device)
            if bool(skip.all()):
                skip[0] = False
        else:
            skip = torch.zeros((G,), dtype=torch.bool, device=device)
        return n_active, skip

    def draw_sample_idx(self, skip: torch.Tensor, T: int,
                        generator=None) -> torch.Tensor:
        """Each stage's K dead-code candidates (nq, K): indices into the
        global batch's G x T flattened encodings, uniform over the steps
        (padding included) of the rows not skipped."""
        c = self.cfg
        notskip = (~skip).to(torch.float32)
        flat_p = (notskip / notskip.sum().clamp_min(1.0) / T
                  ).repeat_interleave(T)
        return torch.multinomial(
            flat_p.to(_gen_device(generator)).expand(c.num_quantizers, -1),
            c.codebook_size, replacement=True, generator=generator)

    def kmeans_init_call(self, z: torch.Tensor, lengths: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         num_iters: int = 10,
                         init_idx_override: Optional[torch.Tensor] = None):
        """Sequential k-means initialization of every stage on one batch:
        stage i starts from the current residual, then quantizes with its
        fresh codebook before stage i + 1. ``init_idx_override`` (nq, K)
        pins each stage's starting rows of the flattened (B x T, D)
        residual. Returns (new_codebook (nq, K, D), cluster_sizes (nq,
        K))."""
        c = self.cfg
        z = self._project_in(z)
        B, T, _ = z.shape
        mask = (torch.arange(T, device=z.device)[None, :]
                < lengths[:, None])[..., None]
        zero = torch.zeros((), dtype=z.dtype, device=z.device)
        residual = z
        new_cbs, bins_all = [], []
        for i in range(c.num_quantizers):
            masked = torch.where(mask, residual, zero)
            enc = masked.reshape(B * T, -1)
            init = (None if init_idx_override is None
                    else enc[init_idx_override[i].to(enc.device).long()])
            means, bins = kmeans_init(enc, c.codebook_size, generator,
                                      num_iters, init_means=init)
            new_cbs.append(means)
            bins_all.append(bins)
            residual = residual - torch.where(
                mask, means[nearest_codes(masked, means)], zero)
        return torch.stack(new_cbs), torch.stack(bins_all)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (nq, B, T) -> embeddings (B, T, output_dim), fp32: the sum
        of the stages' codebook rows, then the output projection."""
        emb = torch.zeros(codes.shape[1:] + (self.cfg.codebook_dim,),
                          dtype=torch.float32, device=codes.device)
        for i in range(codes.shape[0]):
            emb = emb + self.codebook[i][codes[i].long()]
        return self._project_out(emb)


# ---------------------------------------------------------------------------
# EMA codebook training
# ---------------------------------------------------------------------------

def _world(group) -> Tuple[int, int]:
    if group is None:
        return 1, 0
    import torch.distributed as dist
    return dist.get_world_size(group), dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """SUM over the ranks of ``group`` (the identity without one), outside
    autograd: only statistics and counts go through it."""
    if group is None:
        return x
    x = x.detach().clone()
    torch.distributed.all_reduce(x, group=group)
    return x


def _gen_device(generator: Optional[torch.Generator]):
    return generator.device if generator is not None else "cpu"


def ema_update(cluster_size: torch.Tensor, embed_avg: torch.Tensor,
               codebook: torch.Tensor, encodings: torch.Tensor,
               indices: torch.Tensor, decay: float = 0.99,
               epsilon: float = 1e-5, group=None):
    """One EMA codebook update of one stage: encodings (N, D) assigned
    ``indices`` (N,) this step. Under ``group`` the batch statistics are
    summed over its ranks (``all_reduce``, where JAX's takes ``psum`` over
    ``axis_name``). Returns (new_cluster_size, new_embed_avg,
    new_codebook)."""
    K = codebook.shape[0]
    onehot = F.one_hot(indices.long(), K).to(torch.float32)        # (N, K)
    cluster_new = _all_reduce(onehot.sum(dim=0), group)
    embed_sum = _all_reduce(encodings.to(torch.float32).T @ onehot, group)
    new_cluster = cluster_size * decay + cluster_new * (1 - decay)
    new_avg = embed_avg * decay + embed_sum.T * (1 - decay)
    n = new_cluster.sum()
    smoothed = (new_cluster + epsilon) / (n + K * epsilon) * n
    return new_cluster, new_avg, new_avg / smoothed[:, None]


def ema_update_stacked(cluster_size: torch.Tensor, embed_avg: torch.Tensor,
                       cluster_new: torch.Tensor, embed_sum: torch.Tensor,
                       decay: float = 0.99, epsilon: float = 1e-5):
    """The EMA update of every stage at once from ``train_call``'s stats:
    cluster_size / cluster_new (nq, K), embed_avg / embed_sum (nq, K, D).
    Returns (new_cluster_size, new_embed_avg, new_codebook)."""
    K = cluster_size.shape[-1]
    new_cluster = cluster_size * decay + cluster_new * (1 - decay)
    new_avg = embed_avg * decay + embed_sum * (1 - decay)
    n = new_cluster.sum(dim=-1, keepdim=True)                       # (nq, 1)
    smoothed = (new_cluster + epsilon) / (n + K * epsilon) * n      # (nq, K)
    return new_cluster, new_avg, new_avg / smoothed[..., None]


def replace_dead_codes(codebook: torch.Tensor, cluster_size: torch.Tensor,
                       encodings: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       threshold: float = 2.0,
                       idx_override: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Codebook rows whose EMA count is under ``threshold`` take a row of
    ``encodings`` (N, D): K indices drawn uniformly in [0, N) from
    ``generator``, or ``idx_override`` (K,)."""
    K, N = codebook.shape[0], encodings.shape[0]
    if idx_override is not None:
        idx = idx_override.to(encodings.device).long()
    else:
        idx = torch.randint(0, N, (K,), generator=generator,
                            device=_gen_device(generator)).to(
                                encodings.device)
    samples = encodings.to(torch.float32)[idx]
    dead = cluster_size < threshold
    return torch.where(dead[:, None], samples, codebook)


def kmeans_init(encodings: torch.Tensor, num_clusters: int,
                generator: Optional[torch.Generator] = None,
                num_iters: int = 10,
                init_means: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means codebook init of ``encodings`` (N, D). The start is
    ``init_means``, or K rows drawn from ``generator``: a permutation's
    first K when N >= K, with replacement otherwise. Returns (means (K, D),
    bins (K,))."""
    x = encodings.to(torch.float32)
    N = x.shape[0]
    if init_means is None:
        gdev = _gen_device(generator)
        if N >= num_clusters:
            idx = torch.randperm(N, generator=generator,
                                 device=gdev)[:num_clusters]
        else:
            idx = torch.randint(0, N, (num_clusters,), generator=generator,
                                device=gdev)
        means = x[idx.to(x.device)]
    else:
        means = init_means.to(torch.float32)

    def assign(means):
        d = -2.0 * (x @ means.T) + (means * means).sum(dim=-1)[None, :]
        onehot = F.one_hot(d.argmin(dim=-1), num_clusters).to(torch.float32)
        return onehot, onehot.sum(dim=0)

    for _ in range(num_iters):
        onehot, bins = assign(means)
        new_means = (onehot.T @ x) / bins.clamp_min(1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    return means, assign(means)[1]
