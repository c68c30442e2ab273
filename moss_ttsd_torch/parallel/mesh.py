"""The ("data", "model") process mesh and the LM's tensor-parallel layout,
PyTorch port of ``moss_ttsd_tpu/parallel/mesh.py``.

The JAX package names shardings and lets XLA insert the collectives. Here
each process is one cell of the mesh and holds plain local tensors; the
collectives are explicit (Megatron style), through the mesh's two process
groups:

  * "data"  — rows of a batch split over the data ranks (``batch_spec``);
    the training step all-reduces its gradients over this group;
  * "model" — the LM's weights split over the model ranks
    (``lm_param_specs`` / ``shard_params``): q/k/v/gate/up colwise (the
    rank's output rows), o/down rowwise (the rank's input columns, one
    all-reduce of the partial product, the bias added after it), the text
    table vocab-parallel (masked lookup + all-reduce; the tied head's
    logits gathered to the full fp32 row). Norms and the speech tables
    (1025 rows) stay whole.

The kernels take plain contiguous tensors, so no DTensor is involved.
Sharding needs ``torch.distributed`` to be up (``parallel/distributed.
initialize_multihost``): one process per mesh cell, ranks laid out data
major, as ``init_device_mesh`` lays them out.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import LMConfig

AXES = ("data", "model")
COLWISE = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROWWISE = ("o_proj", "down_proj")


class Mesh:
    """A ("data", "model") mesh of processes over a ``DeviceMesh``: its
    shape, this process's coordinates and the two axis groups."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.device_type = device_mesh.device_type
        self.shape = {a: device_mesh.size(i) for i, a in enumerate(AXES)}
        self.data_group = device_mesh.get_group("data")
        self.model_group = device_mesh.get_group("model")
        self.data_rank = device_mesh.get_local_rank("data")
        self.model_rank = device_mesh.get_local_rank("model")
        # global rank of this model group's first rank: the source of the
        # sampled tokens every model rank decodes
        self.model_src = dist.get_global_rank(self.model_group, 0)
        self.collectives = 0          # collectives issued (a host counter)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={dist.get_rank()})")

    @property
    def data(self) -> int:
        return self.shape["data"]

    @property
    def model(self) -> int:
        return self.shape["model"]

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
        return TensorParallel(cfg, self.model_rank, self.model, self)


def make_mesh(data: Optional[int] = None, model: int = 1, seq: int = 1,
              device_type: str = "cuda") -> Mesh:
    """A ("data", "model") mesh over every process of the default group
    (``init_device_mesh``, ranks data major). ``data`` defaults to the
    world size over ``model``. ``seq`` > 1 (sequence-parallel training's
    middle axis in JAX) is not ported."""
    if seq > 1:
        raise NotImplementedError("a sequence-parallel 'seq' mesh axis is "
                                  "not yet ported to moss_ttsd_torch")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: "
                           "parallel.distributed.initialize_multihost")
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"{data}x{model} mesh != {world} processes")
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
    axis (JAX ``P("data")``): a contiguous block a data rank."""
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{mesh.data} data ranks")
    per = n // mesh.data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


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
