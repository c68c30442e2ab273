"""The process meshes and the LM's tensor- and sequence-parallel layouts,
PyTorch port of ``moss_ttsd_tpu/parallel/mesh.py``.

The JAX package names shardings and lets XLA insert the collectives. Here
each process is one cell of the mesh and holds plain local tensors; the
collectives are explicit (Megatron style), through the mesh's axis
process groups:

  * "data"  — rows of a batch split over the data ranks (``batch_spec``);
    the training step all-reduces its gradients over this group;
  * "seq"   — (``make_mesh(seq=)`` > 1, sequence-parallel training) the
    time axis of each data rank's rows split over the seq ranks
    (``seq_spec``): each rank runs its T/sp query rows and attends over
    every rank's keys, gathered after RoPE (``SequenceParallel``);
  * "model" — the LM's weights split over the model ranks
    (``lm_param_specs`` / ``shard_params``): q/k/v/gate/up colwise (the
    rank's output rows), o/down rowwise (the rank's input columns, one
    all-reduce of the partial product, the bias added after it), the text
    table vocab-parallel (masked lookup + all-reduce; the tied head's
    logits gathered to the full fp32 row). Norms and the speech tables
    (1025 rows) stay whole.

``parallel/pipeline.make_pp_mesh`` builds a ("pipe", "data") mesh of the
same class. The kernels take plain contiguous tensors, so no DTensor is
involved. A mesh needs ``torch.distributed`` to be up
(``parallel/distributed.initialize_multihost``): one process per mesh cell,
ranks laid out with the first axis major, as ``init_device_mesh`` lays
them out.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import LMConfig

AXES = ("data", "model")
SEQ_AXES = ("data", "seq", "model")
COLWISE = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROWWISE = ("o_proj", "down_proj")


class Mesh:
    """A mesh of processes over a ``DeviceMesh``: its shape by axis name,
    this process's coordinates and the axis groups. An axis the mesh does
    not have has size 1, coordinate 0 and no group."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.device_type = device_mesh.device_type
        axes = device_mesh.mesh_dim_names
        self.shape = {a: device_mesh.size(i) for i, a in enumerate(axes)}
        groups = {a: device_mesh.get_group(a) for a in axes}
        ranks = {a: device_mesh.get_local_rank(a) for a in axes}
        self.data_group = groups.get("data")
        self.model_group = groups.get("model")
        self.seq_group = groups.get("seq")
        self.pipe_group = groups.get("pipe")
        self.data_rank = ranks.get("data", 0)
        self.model_rank = ranks.get("model", 0)
        self.seq_rank = ranks.get("seq", 0)
        self.pipe_rank = ranks.get("pipe", 0)
        # global rank of this model group's first rank: the source of the
        # sampled tokens every model rank decodes
        self.model_src = (dist.get_global_rank(self.model_group, 0)
                          if self.model_group is not None else dist.get_rank())
        self.collectives = 0          # collectives issued (a host counter)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}, rank={dist.get_rank()})"

    @property
    def data(self) -> int:
        return self.shape.get("data", 1)

    @property
    def model(self) -> int:
        return self.shape.get("model", 1)

    @property
    def seq(self) -> int:
        return self.shape.get("seq", 1)

    @property
    def pipe(self) -> int:
        return self.shape.get("pipe", 1)

    @property
    def train_group(self):
        """The group a data-parallel training step sums over: the data
        ranks, or with a seq axis every data x seq rank (the whole mesh;
        the model axis must then be 1)."""
        if self.seq == 1:
            return self.data_group
        if self.model != 1:
            raise NotImplementedError("sequence parallelism with a model "
                                      "axis > 1 is not ported")
        return dist.group.WORLD

    def all_reduce(self, x: torch.Tensor, group, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """In place over ``group`` (a no-op on a group of one)."""
        if dist.get_world_size(group) > 1:
            dist.all_reduce(x, op=op, group=group)
            self.collectives += 1
        return x

    def any_unfinished(self, flags: torch.Tensor) -> bool:
        """``flags.any()`` over every rank of the mesh: the step loop's
        test, so that every data rank runs the same steps (the JAX loop
        runs over the whole batch). Its one host sync."""
        if self.data == 1:
            return bool(flags.any())
        t = flags.any().to(torch.int32).reshape(1)
        return bool(self.all_reduce(t, None, dist.ReduceOp.MAX))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x`` (its dim 0), in rank order, on
        every rank: a sum over the data group of zero buffers each rank
        filled with its own rows (exact; gloo and NCCL both take it)."""
        if self.data == 1:
            return x
        n = x.shape[0]
        buf = torch.zeros((n * self.data,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        buf[self.data_rank * n:(self.data_rank + 1) * n] = x
        return self.all_reduce(buf, self.data_group)

    def tensor_parallel(self, cfg: LMConfig) -> Optional["TensorParallel"]:
        """The model axis's layout of ``cfg``'s LM, None without one."""
        if self.model == 1:
            return None
        cfg.refuse_afmoe("a tensor-parallel mesh")
        return TensorParallel(cfg, self.model_rank, self.model, self)

    def sequence_parallel(self) -> Optional["SequenceParallel"]:
        """The seq axis's split of the time axis, None without one."""
        if self.seq == 1:
            return None
        return SequenceParallel(self.seq_rank, self.seq, self.seq_group,
                                self)


def make_mesh(data: Optional[int] = None, model: int = 1, seq: int = 1,
              device_type: str = "cuda") -> Mesh:
    """A ("data", "model") mesh over every process of the default group
    (``init_device_mesh``, ranks data major). ``data`` defaults to the
    world size over ``model`` x ``seq``. With ``seq`` > 1 the mesh gains a
    middle "seq" axis, ("data", "seq", "model"), for sequence-parallel
    training, as JAX's does; "data" and "model" keep their meaning."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: "
                           "parallel.distributed.initialize_multihost")
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if data is None:
        data = world // (model * seq)
    if data * seq * model != world:
        raise ValueError(f"{data}x{seq}x{model} mesh != {world} processes")
    if seq > 1:
        return Mesh(init_device_mesh(device_type, (data, seq, model),
                                     mesh_dim_names=SEQ_AXES))
    return Mesh(init_device_mesh(device_type, (data, model),
                                 mesh_dim_names=AXES))


def parse_mesh_arg(spec: str, device_type: str = "cuda") -> Mesh:
    """CLI "DATAxMODEL" (e.g. "1x2") -> the mesh over the process group.
    D x M must equal the group's world size (ValueError otherwise). A
    1x1 mesh without a group joins a one-process group of its own."""
    try:
        data, model = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected DATAxMODEL, e.g. "
                         f"1x2") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec}: both axes must be >= 1")
    n = data * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"--mesh {spec} needs {n} processes, the group "
                         f"has {world}")
    if not dist.is_initialized():
        from .distributed import initialize_multihost, local_init_method
        initialize_multihost(local_init_method(), 1, 0, device=device_type)
    return make_mesh(data=data, model=model, device_type=device_type)


def batch_spec(mesh: Mesh, n: int) -> slice:
    """This process's rows of an ``n``-row batch split over the "data"
    axis (JAX ``P("data")``): a contiguous block a data rank. The seq
    ranks of one data rank hold the same rows."""
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{mesh.data} data ranks")
    per = n // mesh.data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def seq_spec(mesh: Mesh, T: int) -> slice:
    """This process's time steps [r T/sp, (r+1) T/sp) of a length-``T``
    time axis split over the "seq" axis (the time half of JAX's
    ``P("data", "seq")``); the whole axis without one."""
    sp = mesh.sequence_parallel()
    return slice(0, T) if sp is None else sp.window(T)


class SequenceParallel:
    """One seq rank's share of the time axis, and the gather of the keys
    and values the attention needs from every rank.

    The time axis (padded by the collate to a multiple of 64) splits into
    ``size`` equal windows; rank r holds [r T/size, (r+1) T/size). Each
    rank's queries attend over the whole row: ``gather`` all-gathers a
    (B, T/size, ...) tensor over the seq group into (B, T, ...) in rank
    order, and its backward sums the (B, T, ...) cotangents of every
    rank (in fp32) and keeps this rank's window. Under remat the gather
    runs again in the recomputed forward, so no gathered K/V is saved
    across layers."""

    def __init__(self, rank: int, size: int, group=None,
                 mesh: Optional[Mesh] = None):
        self.rank, self.size, self.group, self.mesh = rank, size, group, mesh

    def window(self, T: int) -> slice:
        if T % self.size:
            raise ValueError(f"a time axis of {T} steps does not split "
                             f"over {self.size} seq ranks")
        per = T // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """``x``'s window on its time ``axis``. A leaf with no such axis
        stays whole: no spec is wider than the leaf, as in JAX."""
        if x.ndim <= axis:
            return x
        w = self.window(x.shape[axis])
        return x.narrow(axis, w.start, w.stop - w.start)

    def _count(self) -> None:
        if self.mesh is not None:
            self.mesh.collectives += 1

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T/size, ...) -> (B, T, ...), every rank's window in order
        (differentiable)."""
        return _SeqGather.apply(x, self)


class _SeqGather(torch.autograd.Function):
    """The gather is a sum over the seq group of zero buffers each rank
    filled with its window, in fp32: exact, and the one collective that
    gloo takes for CUDA tensors as NCCL does."""

    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        T = x.shape[1] * sp.size
        full = x.new_zeros((x.shape[0], T) + tuple(x.shape[2:]),
                           dtype=torch.float32)
        full[:, sp.window(T)] = x
        dist.all_reduce(full, group=sp.group)
        sp._count()
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        full = g.float().contiguous()
        dist.all_reduce(full, group=sp.group)
        sp._count()
        w = sp.window(full.shape[1])
        return full[:, w].to(g.dtype).contiguous(), None


# -- the LM's tensor-parallel layout ------------------------------------------

def _proj(name: str) -> Optional[str]:
    for p in COLWISE + ROWWISE:
        if f".{p}." in name:
            return p
    return None


def _out_dim(cfg: LMConfig, proj: str) -> int:
    H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    return {"q_proj": H * D, "k_proj": Hkv * D, "v_proj": Hkv * D,
            "gate_proj": cfg.intermediate_size,
            "up_proj": cfg.intermediate_size}[proj]


def _in_dim(cfg: LMConfig, proj: str) -> int:
    return {"o_proj": cfg.num_attention_heads * cfg.head_dim,
            "down_proj": cfg.intermediate_size}[proj]


def lm_param_specs(params: Mapping[str, torch.Tensor], cfg: LMConfig,
                   model_size: Optional[int] = None) -> Dict[str, str]:
    """Each parameter of the port's LM state dict -> "colwise", "rowwise",
    "vocab" or "replicated" (JAX ``lm_param_specs``):

      * q/k/v/gate/up weights (``weight``, int8 ``weight_q`` / ``weight_s``)
        and their biases: colwise (split on the output features);
      * o/down weights: rowwise (split on the input features); their
        ``weight_s`` (one scale per output row) and bias stay whole;
      * the text table (``embed_text``, ``embed_text_q`` / ``_s``): vocab;
      * LoRA factors: a colwise target's ``lora_b`` colwise, a rowwise
        target's ``lora_a`` rowwise, the other factor whole;
      * norms and the speech tables: replicated. (JAX would split a speech
        vocab the model size divides; the port keeps the tables whole at
        any size; the model's 1025 rows divide by none.)

    With ``model_size`` a spec whose split dimension it does not divide
    degrades to replicated, as in JAX. The k/v "colwise" split is by the KV
    heads the rank's query heads read (``TensorParallel.kv_heads``)."""
    out = {}
    for name in params:
        leaf = name.rsplit(".", 1)[-1]
        proj = _proj(name)
        kind, size = "replicated", None
        if name.startswith("embed_text"):
            kind, size = "vocab", cfg.vocab_size
        elif proj in COLWISE and leaf != "lora_a":
            kind, size = "colwise", _out_dim(cfg, proj)
        elif proj in ROWWISE and leaf in ("weight", "weight_q", "lora_a"):
            kind, size = "rowwise", _in_dim(cfg, proj)
        if (kind != "replicated" and model_size is not None
                and size % model_size):
            kind = "replicated"
        out[name] = kind
    return out


def kv_heads_for(rank: int, size: int, H: int, Hkv: int) -> List[int]:
    """The KV heads model rank ``rank`` of ``size`` holds: those its query
    heads [rank H/size, (rank+1) H/size) read (head h reads KV head
    h // (H/Hkv)). Where the rank's query heads are a whole number of
    groups it holds those groups' heads; where they lie inside one group
    (Hkv < size: the heads are replicated) it holds that one; otherwise
    one KV head per query head, so every rank attends with a uniform
    group."""
    G = H // Hkv
    hl = H // size
    q0 = rank * hl
    if hl % G == 0:
        return list(range(q0 // G, q0 // G + hl // G))
    if G % hl == 0:
        return [q0 // G]
    return [(q0 + i) // G for i in range(hl)]


class TensorParallel:
    """One model rank's share of the LM, and the model axis's collectives.

    ``H % size`` must be 0 (JAX would shard mid-head there; the port's
    attention is by whole heads). Sizes that do not divide the MLP width or
    the text vocab keep those replicated, as ``lm_param_specs`` degrades."""

    def __init__(self, cfg: LMConfig, rank: int, size: int,
                 mesh: Optional[Mesh] = None):
        H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        if H % size:
            raise ValueError(
                f"tensor parallelism over {size} ranks needs the "
                f"{H} query heads to divide by it (the JAX package would "
                f"shard inside a head there; the port does not)")
        self.cfg, self.rank, self.size, self.mesh = cfg, rank, size, mesh
        self.group = None if mesh is None else mesh.model_group
        self.heads = H // size
        self.q0 = rank * self.heads
        self.kv_heads = kv_heads_for(rank, size, H, Hkv)
        I = cfg.intermediate_size
        self.mlp_split = I % size == 0
        self.ffn = I // size if self.mlp_split else I
        V = cfg.vocab_size
        self.vocab_split = V % size == 0
        per = V // size if self.vocab_split else V
        self.vocab = ((rank * per, (rank + 1) * per) if self.vocab_split
                      else (0, V))

    # -- index sets --------------------------------------------------------

    def _heads(self, heads) -> np.ndarray:
        D = self.cfg.head_dim
        return (np.asarray(heads)[:, None] * D + np.arange(D)).reshape(-1)

    def out_index(self, proj: str) -> Optional[np.ndarray]:
        """The rank's output features of a colwise projection (None: all)."""
        if proj == "q_proj":
            return self._heads(range(self.q0, self.q0 + self.heads))
        if proj in ("k_proj", "v_proj"):
            return self._heads(self.kv_heads)
        if self.mlp_split:
            return np.arange(self.rank * self.ffn, (self.rank + 1) * self.ffn)
        return None

    def in_index(self, proj: str) -> Optional[np.ndarray]:
        """The rank's input features of a rowwise projection (None: all)."""
        if proj == "o_proj":
            return self._heads(range(self.q0, self.q0 + self.heads))
        if self.mlp_split:
            return np.arange(self.rank * self.ffn, (self.rank + 1) * self.ffn)
        return None

    def is_rowwise(self, proj: str) -> bool:
        """Whether ``proj``'s product is partial (reduced over the axis)."""
        return proj == "o_proj" or (proj == "down_proj" and self.mlp_split)

    def shard_tensor(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the full parameter ``name``."""
        leaf = name.rsplit(".", 1)[-1]
        proj = _proj(name)
        idx, dim = None, 0
        if name.startswith("embed_text") and self.vocab_split:
            return x[self.vocab[0]:self.vocab[1]].contiguous()
        if proj in COLWISE:
            idx = self.out_index(proj)
            dim = 1 if leaf == "lora_b" else 0
            if leaf == "lora_a":
                idx = None
        elif proj in ROWWISE:
            idx = self.in_index(proj)
            dim = 0 if leaf == "lora_a" else 1
            if leaf not in ("weight", "weight_q", "lora_a"):
                idx = None
        if idx is None:
            return x
        return x.index_select(dim, torch.as_tensor(idx, device=x.device)
                              ).contiguous()

    def shard_lora(self, target: str, a: np.ndarray, b: np.ndarray):
        """A registry stack (a (L, N, in, r), b (L, N, r, out)) -> the
        rank's: a colwise target's b on its outputs, a rowwise target's a
        on its inputs."""
        if target in COLWISE:
            idx = self.out_index(target)
            return a, (b if idx is None else b[..., idx])
        idx = self.in_index(target)
        return (a if idx is None else a[:, :, idx]), b

    # -- collectives -------------------------------------------------------

    def _reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        if self.mesh is None:
            raise RuntimeError("a TensorParallel layout without a mesh runs "
                               "no collectives")
        return self.mesh.all_reduce(x, self.group, op)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' partial products, in fp32, cast back."""
        return self._reduce(y.float().contiguous()).to(y.dtype)

    def gather_vocab(self, t: torch.Tensor, lo: int, hi: int
                     ) -> torch.Tensor:
        """(N, rows) fp32 logits of the rank's table rows inside [lo, hi)
        -> the full (N, hi - lo) row on every rank."""
        if not self.vocab_split:
            return t
        v0, v1 = self.window(lo, hi)
        out = torch.zeros((t.shape[0], hi - lo), dtype=t.dtype,
                          device=t.device)
        if v1 > v0:
            out[:, v0 - lo:v1 - lo] = t
        return self._reduce(out)

    def window(self, lo: int, hi: int):
        """The rank's table rows inside [lo, hi) (empty: v1 <= v0)."""
        if not self.vocab_split:
            return lo, hi
        return max(lo, self.vocab[0]), min(hi, self.vocab[1])

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x.contiguous(), dist.ReduceOp.MAX)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The model group's first rank's ``x`` on every model rank."""
        x = x.contiguous()
        dist.broadcast(x, src=self.mesh.model_src, group=self.group)
        self.mesh.collectives += 1
        return x


def shard_params(state: Mapping[str, torch.Tensor], mesh: Mesh,
                 cfg: LMConfig) -> Dict[str, torch.Tensor]:
    """This process's shard of the full LM state dict (the tree
    ``utils/convert_jax.lm_state_from_jax`` or ``convert_lm`` carries
    across): each parameter cut to the model rank's part of the layout
    ``lm_param_specs`` names (``TensorParallel.shard_tensor``; q/k/v by
    whole heads); replicated ones are kept as they are."""
    tp = mesh.tensor_parallel(cfg)
    if tp is None:
        return dict(state)
    return {k: tp.shard_tensor(k, v) for k, v in state.items()}
