"""Device mesh and sharding rules (port of hamer_yolo_tpu/parallel/mesh.py)
on torch.distributed: one process per device, as torchrun starts them.

- ``make_mesh``: a torch DeviceMesh with JAX's axes ("data", "model"), or
  ("replica", "data", "model"); NCCL on the card, gloo on the CPU.
- Data parallelism: the batch is split over the data axes (replica + data).
  Each rank runs the model on its rows; ``gather_rows`` gathers the outputs
  of every rank, the other ranks' rows detached, so that the loss is the
  global batch's loss on every rank, and ``reduce_grads`` sums each rank's
  share of its gradient over the data axes: the global batch's gradient,
  what JAX's partitioner computes for a loss that is not a mean of
  per-sample terms too (YOLO's, normalised by the batch's targets). BatchNorm
  over the batch statistics takes its moments over the data axes
  (``DataMean``), with the same running stats on every rank, as XLA's
  partitioner does for the sharded JAX step (SyncBatchNorm's semantics).
- Tensor parallelism: ``vit_tp_shardings`` names the Megatron split of each
  matrix, JAX's rules. Inside ``tensor_parallel(mesh)`` the layers of
  core/nn.py (self and cross attention, the GELU MLP) compute with the
  rank's split: qkv / to_q / to_kv / fc1 by columns, proj / fc2 by rows,
  one all-reduce after proj and one after fc2; the attention's column split
  keeps whole heads (JAX's P(None, "model") cuts the flat columns and XLA
  then regathers the heads). Every rank keeps the whole parameter tree and
  its optimizer: ``reduce_grads`` sums the split matrices' gradients, each
  rank's slice, over "model". The train steps run the plain layers (no
  kernel sees a split).

``shard_params`` / ``shard_batch`` lay a tree out as DTensors under
``NamedSharding`` placements, the JAX functions' counterparts.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import socket
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from hamer_yolo_tpu_torch.core import nn

DATA_AXES = ("replica", "data")
# The collectives' time limit: a rank that hangs fails its peers after this.
TIMEOUT_S = 300.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device="cuda", timeout_s: float = TIMEOUT_S) -> Tuple[int, int]:
    """Join the process group, once: torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) where it is set, else a group of
    this one process on localhost. NCCL for a CUDA ``device`` (each rank on
    cuda:LOCAL_RANK), gloo for the CPU. Returns (rank, world size)."""
    if not dist.is_initialized():
        cuda = torch.device(device).type == "cuda"
        timeout = datetime.timedelta(seconds=timeout_s)
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl" if cuda else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
        else:
            dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                                    rank=0, world_size=1, timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def broadcast_object(obj: Any, device=None) -> Any:
    """Rank 0's ``obj`` (any picklable value) on every rank; ``device`` is
    this rank's, which NCCL needs for the bytes it moves."""
    box = [obj]
    dev = torch.device(device) if device is not None else None
    dist.broadcast_object_list(box, src=0, device=dev if dev is not None and dev.type == "cuda"
                               else None)
    return box[0]


def local_device(device="cuda") -> torch.device:
    """This rank's device: cuda:LOCAL_RANK for a CUDA ``device``, else ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _device_type(devices) -> str:
    if devices is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices).type
    return torch.device(list(devices)[0]).type


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None,
              n_replica: int = 1) -> DeviceMesh:
    """("data", "model") mesh over the process group's ranks, or
    ("replica", "data", "model") where ``n_replica`` > 1: the outer replica
    axis is pure data parallelism (JAX's cross-host DCN axis). ``devices``:
    a device type, or devices whose type the mesh takes (the card where one
    is visible, else the CPU). One rank per device: the mesh must cover the
    world (torch's DeviceMesh spans it), where JAX may take a prefix of its
    devices."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_model * n_replica)
    need = n_data * n_model * n_replica
    if need != world:
        raise ValueError(f"a {n_replica} x {n_data} x {n_model} mesh needs {need} ranks; "
                         f"the process group has {world}")
    if n_replica == 1:
        return init_device_mesh(_device_type(devices), (n_data, n_model),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh(_device_type(devices), (n_replica, n_data, n_model),
                            mesh_dim_names=("replica", "data", "model"))


def make_hybrid_mesh(n_model: int = 1) -> DeviceMesh:
    """JAX's multi-host mesh (replica over hosts); one host, as here, takes
    ``make_mesh``, as JAX does on a single process."""
    return make_mesh(n_model=n_model)


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Mesh axes the batch dim is split over (replica + data where present)."""
    return tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name)) if name in mesh.mesh_dim_names else 1


def data_shards(mesh: Optional[DeviceMesh]) -> int:
    """How many ways the batch is split."""
    if mesh is None:
        return 1
    n = 1
    for a in data_axes(mesh):
        n *= _axis_size(mesh, a)
    return n


def data_index(mesh: DeviceMesh) -> int:
    """This rank's block of the batch, replica-major (JAX's P(("replica", "data")))."""
    idx = 0
    for a in data_axes(mesh):
        idx = idx * _axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a placement per mesh axis (jax.sharding.NamedSharding)."""
    mesh: DeviceMesh
    placements: Tuple[Any, ...]

    @property
    def spec(self) -> Tuple[Optional[str], ...]:
        """JAX's PartitionSpec of a 2-D leaf: the axes each tensor dim is split over."""
        dims: Dict[int, List[str]] = {}
        for name, p in zip(self.mesh.mesh_dim_names, self.placements):
            if isinstance(p, Shard):
                dims.setdefault(p.dim, []).append(name)
        if not dims:
            return ()
        out = []
        for d in range(max(dims) + 1):
            names = dims.get(d, [])
            out.append(None if not names else names[0] if len(names) == 1 else tuple(names))
        return tuple(out)


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, (Replicate(),) * mesh.ndim)


def batch_sharding(mesh: DeviceMesh, ndim: int = 4) -> NamedSharding:
    """The leading (batch) dim split over the data axes (replica + data)."""
    axes = data_axes(mesh)
    return NamedSharding(mesh, tuple(Shard(0) if a in axes else Replicate()
                                     for a in mesh.mesh_dim_names))


def _tp_spec_for_path(path: str, ndim: int):
    """The "model" axis' placement of a ViT / HaMeR leaf by its tree path,
    JAX's Megatron rules: qkv, to_q, to_kv and the MLP's up projections
    split their output dim, proj and the down projections their input dim
    (the linears keep JAX's (in, out) layout, so JAX's P(None, "model") is
    Shard(1) here)."""
    if ndim != 2:
        return Replicate()
    if any(k in path for k in ("qkv", "to_q", "to_kv", "fc1", "pw1")):
        return Shard(1)
    if any(k in path for k in ("proj", "fc2", "pw2")):
        return Shard(0)
    return Replicate()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def vit_tp_shardings(params: Any, mesh: DeviceMesh) -> Any:
    """A NamedSharding per leaf: attention and MLP matrices split over
    "model", everything else replicated."""
    def one(path, leaf):
        spec = _tp_spec_for_path(path, getattr(leaf, "ndim", 0))
        return NamedSharding(mesh, tuple(spec if a == "model" else Replicate()
                                         for a in mesh.mesh_dim_names))

    return _map_with_path(one, params)


def shard_params(params: Any, shardings: Any) -> Any:
    """Each tensor leaf as a DTensor laid out by its NamedSharding."""
    def one(leaf, sh):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, sh.mesh, list(sh.placements))

    if isinstance(params, dict):
        return {k: shard_params(v, shardings[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(v, s) for v, s in zip(params, shardings))
    return one(params, shardings)


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """Each tensor of a batch as a DTensor split by rows over the data axes."""
    sh = batch_sharding(mesh)
    return _map_with_path(
        lambda _, x: distribute_tensor(x, mesh, list(sh.placements))
        if isinstance(x, torch.Tensor) else x, batch)


# ---------------------------------------------------------------------------
# The data-parallel step's pieces
# ---------------------------------------------------------------------------

def local_rows(tree: Any, mesh: Optional[DeviceMesh]) -> Any:
    """This rank's rows of each array of a global batch (tensors, numpy)."""
    if mesh is None:
        return tree
    n, i = data_shards(mesh), data_index(mesh)

    def one(_, x):
        if not hasattr(x, "shape") or not len(x.shape):
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by the data axes ({n})")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return _map_with_path(one, tree)


def gather_rows(tree: Any, mesh: Optional[DeviceMesh]) -> Any:
    """Every rank's rows of each tensor, in batch order: this rank's as they
    are (with their autograd history), the others' detached."""
    if mesh is None:
        return tree
    axes = data_axes(mesh)

    def one(_, t):
        if not isinstance(t, torch.Tensor):
            return t
        for a in reversed(axes):  # the inner axis first: a replica's block, then the batch
            group = mesh.get_group(a)
            if group.size() == 1:  # nothing to gather: the tensor as it is, strides and all
                continue
            sent = t.detach().contiguous()
            if sent.dtype == torch.bool:  # not every backend moves bool
                sent = sent.view(torch.uint8)
            parts = [torch.empty_like(sent) for _ in range(group.size())]
            dist.all_gather(parts, sent, group=group)
            parts = [p.view(t.dtype) for p in parts]
            parts[mesh.get_local_rank(a)] = t
            t = torch.cat(parts)
        return t

    return _map_with_path(one, tree)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group, forward and backward: the gradient of a summed
    moment reaches every rank's rows."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class DataMean:
    """A moment of the global batch from this rank's (equal-sized) block:
    the mean over the data axes, its gradient included. ``shards``: blocks."""

    def __init__(self, mesh: DeviceMesh):
        self.groups = [mesh.get_group(a) for a in data_axes(mesh)]
        self.shards = data_shards(mesh)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        for g in self.groups:
            t = _AllReduceSum.apply(t, g)
        return t / self.shards


def _coalesced_all_reduce(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, one collective per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def reduce_grads(leaves: Sequence[torch.Tensor], mesh: Optional[DeviceMesh],
                 split: Optional["TensorParallel"] = None) -> None:
    """Sum each leaf's .grad, this rank's share of the global batch's
    gradient, over the data axes; first, a matrix that ``split`` computed by
    its slices sums its slices' gradients over "model"."""
    if mesh is None:
        return
    if split is not None and split.size > 1:
        ids = split.split_ids
        _coalesced_all_reduce([p.grad for p in leaves if id(p) in ids], split.group)
    grads = [p.grad for p in leaves if p.grad is not None]
    for a in data_axes(mesh):
        _coalesced_all_reduce(grads, mesh.get_group(a))


# ---------------------------------------------------------------------------
# Tensor parallelism (Megatron's column / row split over "model")
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (each rank
    backpropagates through its own slice only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the model group; identity backward."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel:
    """The split of core/nn.py's attention and MLP layers over a model
    group (``tensor_parallel`` turns it on); ``split_ids`` records the
    parameters computed by slices."""

    def __init__(self, group):
        self.group = group
        self.size = group.size()
        self.rank = dist.get_rank(group)
        self.split_ids: set = set()

    def _mark(self, *ts):
        self.split_ids.update(id(t) for t in ts if t is not None)

    def cols(self, t: Optional[torch.Tensor], parts: int, heads: int) -> Optional[torch.Tensor]:
        """This rank's heads of each of ``parts`` (q, k, v) along the last dim."""
        if t is None:
            return None
        if heads % self.size:
            raise ValueError(f"{heads} heads do not split over {self.size} model ranks")
        hl = heads // self.size
        lead = t.shape[:-1]
        v = t.reshape(*lead, parts, heads, -1)[..., self.rank * hl:(self.rank + 1) * hl, :]
        return v.reshape(*lead, -1)

    def rows(self, w: torch.Tensor) -> torch.Tensor:
        n = w.shape[0] // self.size
        return w[self.rank * n:(self.rank + 1) * n]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.group)

    def reduce(self, y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        y = _ReduceFromModel.apply(y, self.group)
        return y if bias is None else y + nn.cast_weight(bias, y.dtype)

    def _col_linear(self, p, parts, heads):
        self._mark(p["w"], p.get("b"))
        q = {"w": self.cols(p["w"], parts, heads)}
        if "b" in p:
            q["b"] = self.cols(p["b"], parts, heads)
        return q

    def _row_linear(self, p):
        self._mark(p["w"])
        return {"w": self.rows(p["w"])}

    def self_attention(self, p, x, num_heads):
        local = {"qkv": self._col_linear(p["qkv"], 3, num_heads),
                 "proj": self._row_linear(p["proj"])}
        y = nn.plain_mha_self_attention(local, self.enter(x), num_heads // self.size)
        return self.reduce(y, p["proj"].get("b"))

    def cross_attention(self, p, x, context, num_heads):
        local = {"to_q": self._col_linear(p["to_q"], 1, num_heads),
                 "to_kv": self._col_linear(p["to_kv"], 2, num_heads),
                 "proj": self._row_linear(p["proj"])}
        y = nn.plain_cross_attention(local, self.enter(x), self.enter(context),
                                     num_heads // self.size)
        return self.reduce(y, p["proj"].get("b"))

    def mlp_gelu(self, p, x):
        local = {"fc1": self._col_linear(p["fc1"], 1, self.size),
                 "fc2": self._row_linear(p["fc2"])}
        return self.reduce(nn.plain_mlp_gelu(local, self.enter(x)), p["fc2"].get("b"))


@contextlib.contextmanager
def tensor_parallel(mesh: Optional[DeviceMesh]):
    """core/nn.py's attention and MLP layers split over the mesh's "model"
    axis for the block (nothing where it has one rank); yields the
    TensorParallel (or None) whose ``split_ids`` ``reduce_grads`` takes."""
    if mesh is None or _axis_size(mesh, "model") == 1:
        yield None
        return
    tp = TensorParallel(mesh.get_group("model"))
    prev, nn.TENSOR_PARALLEL = nn.TENSOR_PARALLEL, tp
    try:
        yield tp
    finally:
        nn.TENSOR_PARALLEL = prev


# ---------------------------------------------------------------------------
# The train tools' --devices / --tp
# ---------------------------------------------------------------------------

def tool_mesh(devices: int, batch: int, device, tp: int = 1,
              indivisible: str = "batch {batch} not divisible by {n} devices; "
                                 "running single-device"):
    """(mesh or None, this rank's device, rank) for a train tool's
    ``--devices N --tp T``, JAX's tools' rules on torchrun's processes, one
    a device: N = 0 takes every rank (one process without torchrun); N must
    equal the world size and T divide it; a batch the data axis (N / T) does not divide
    runs on one device (``indivisible`` says so; the other ranks have
    nothing to do). Raises ValueError on a bad count."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    n_dev = devices or world
    if n_dev != world:
        raise ValueError(f"--devices {n_dev}: one process a device, and {world} started "
                         "(torchrun --nproc-per-node N)")
    if tp < 1 or n_dev % tp:
        raise ValueError(f"--tp {tp} does not divide --devices {n_dev}")
    dev = local_device(device)
    if n_dev == 1:
        return None, dev, 0
    rank, _ = init_distributed(dev)
    n_data = n_dev // tp
    if batch % n_data:
        if rank == 0:
            print(indivisible.format(batch=batch, n=n_data))
        return None, dev, rank
    return make_mesh(n_data=n_data, n_model=tp, devices=dev.type), dev, rank


def leave_distributed() -> None:
    """Leave the process group where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
