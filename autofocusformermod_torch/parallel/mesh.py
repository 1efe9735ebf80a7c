"""Data parallelism over ``torch.distributed``: process groups, the data
and model axes, batch sharding, and the launcher of one process per GPU.

Counterpart of ``autofocusformermod_tpu/parallel/mesh.py``.  The JAX package
runs one jitted program over the global batch, so its BatchNorm statistics,
its criterion's normalisers and its random draws are global by
construction.  Here each process runs its own rows, and the modules that
need the global batch read the active data axis from this module:
``models/layers.py FlaxBatchNorm2d`` all-reduces its statistics,
``position_embedding_sine`` and ``geometry/cluster.py`` the batch's
largest coordinate and distance ratio, ``losses/criterion.py`` its
normalisers, and every generator the step reads draws the global batch's
numbers and keeps this rank's rows (``global_rand``).  They do so inside
``global_batch()``, the block in which the training step runs the global
batch's program; elsewhere (evaluation, a forward of one rank's images)
each process computes on its own batch.  ``make_mesh`` activates a data axis over every rank;
``make_mesh_2d`` a (data x model) ``DeviceMesh``, whose model axis holds
the large matrices sharded (``tp_leaf_spec``, ``shard_state_tp``).

Two groups span the data axis: the one ``DistributedDataParallel`` reduces
gradients over (``axis_group(DATA_AXIS)``), and a second over the same ranks for the
statistics, normalisers and logged losses (``stats_group``), so that their
collectives never interleave with the reducer's buckets.

``launch`` starts one process per GPU as detectron2's ``launch`` does;
``init_from_env`` joins a group that ``torchrun`` describes (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``).  NCCL serves CUDA devices, gloo the CPU; an
explicit ``device_map`` (with gloo) may put several ranks on one device.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch import distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the active axes: {axis: (group, this process's index on it, its size)},
# plus the statistics group of the data axis
_AXES: Dict[str, Tuple] = {}
# inside the training step's global-batch program (``global_batch``)
_GLOBAL_BATCH = contextvars.ContextVar("global_batch", default=False)


def _set_axis(name: str, group, ranks: Sequence[int]) -> None:
    ranks = list(ranks)
    _AXES[name] = (group, ranks.index(dist.get_rank()), len(ranks))


def axis_size(name: str = DATA_AXIS) -> int:
    """The number of processes along an active axis (1 where none is)."""
    return _AXES[name][2] if name in _AXES else 1


def axis_index(name: str = DATA_AXIS) -> int:
    """This process's index along an active axis (0 where none is)."""
    return _AXES[name][1] if name in _AXES else 0


def axis_group(name: str = DATA_AXIS):
    """The process group of an active axis, or None."""
    return _AXES[name][0] if name in _AXES else None


@contextlib.contextmanager
def global_batch():
    """Within this block the processes of the data axis run one program over
    the global batch: the batch-wide reductions and draws span the axis."""
    token = _GLOBAL_BATCH.set(True)
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def batch_size_factor() -> int:
    """W inside ``global_batch()`` under a data axis of W processes, else 1:
    how many ranks the batch-wide reductions and draws span."""
    return axis_size() if _GLOBAL_BATCH.get() else 1


def stats_group():
    """The second group over the data axis's ranks: statistics, normalisers,
    logged losses."""
    return axis_group("stats")


def distributed() -> bool:
    """Whether this process belongs to a process group with a data axis."""
    return DATA_AXIS in _AXES


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every process of the group (nothing to wait for alone)."""
    if process_count() > 1:
        dist.barrier()


# ------------------------------------------------------------------ meshes
def make_mesh():
    """Activate the data axis over every rank of the world and return its
    group.  Every rank calls it."""
    ranks = list(range(process_count()))
    data = dist.new_group(ranks)
    stats = dist.new_group(ranks)
    _AXES.clear()
    _set_axis(DATA_AXIS, data, ranks)
    _set_axis("stats", stats, ranks)
    return data


def make_mesh_2d(n_data: int, n_model: int):
    """A (data x model) ``DeviceMesh`` over ranks 0 .. n_data * n_model - 1,
    laid out row-major (rank = d * n_model + m), activated: the batch is
    sharded over ``data``, the matrices ``tp_leaf_spec`` names over
    ``model``.  Returns the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_data * n_model != process_count():
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} processes; the "
                         f"group has {process_count()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    rank = process_index()
    d, m = divmod(rank, n_model)
    stats = None
    for col in range(n_model):                   # every rank creates every group
        g = dist.new_group([i * n_model + col for i in range(n_data)])
        if col == m:
            stats = g
    _AXES.clear()
    _set_axis(DATA_AXIS, mesh.get_group(DATA_AXIS), [i * n_model + m for i in range(n_data)])
    _set_axis("stats", stats, [i * n_model + m for i in range(n_data)])
    _set_axis(MODEL_AXIS, mesh.get_group(MODEL_AXIS), [d * n_model + j for j in range(n_model)])
    return mesh


# ----------------------------------------------------------- the batch axis
def shard_batch(batch):
    """This data rank's rows of a global batch (a dict of tensors, arrays or
    lists with the batch leading): rank r of W takes rows r*b/W .. (r+1)*b/W,
    as ``NamedSharding(P("data"))`` lays them out."""
    w, r = axis_size(), axis_index()
    if w == 1:
        return batch

    def rows(v):
        if len(v) % w:
            raise ValueError(f"a global batch of {len(v)} does not split over {w} data ranks")
        b = len(v) // w
        return v[r * b:(r + 1) * b]

    return {k: rows(v) for k, v in batch.items()}


def global_rows(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """This data rank's rows of a tensor drawn for the global batch, laid
    out (groups, global batch, ...) along its first axis and flattened:
    (groups * b * W * per, ...) -> (groups * b * per, ...); W is
    ``batch_size_factor()``."""
    w, r = batch_size_factor(), axis_index()
    if w == 1:
        return x
    per_group = x.shape[0] // groups
    if per_group % w:
        raise ValueError(f"{per_group} rows a group do not split over {w} data ranks")
    local = per_group // w
    return x.reshape(groups, per_group, *x.shape[1:])[:, r * local:(r + 1) * local].reshape(
        groups * local, *x.shape[1:])


def global_rand(shape: Sequence[int], generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """``torch.rand(shape)`` for this data rank's ``shape[0]`` rows: the
    generator draws the global batch's (W * shape[0], ...) numbers, as every
    rank does, and the rank keeps its own rows, so the run at W ranks draws
    what one process draws for the whole batch."""
    w = batch_size_factor()
    shape = tuple(shape)
    u = torch.rand((shape[0] * w, *shape[1:]), generator=generator, device=device)
    return global_rows(u)


class _SumOverGroup(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the all_reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data axis inside ``global_batch()`` (``x``
    itself elsewhere); the gradient flows back to every rank's ``x``."""
    if batch_size_factor() == 1:
        return x
    return _SumOverGroup.apply(x, stats_group())


@torch.no_grad()
def data_sum_detached(x: torch.Tensor) -> torch.Tensor:
    """The sum of a detached ``x`` over the data axis, without gradient
    (inside ``global_batch()``; ``x`` itself elsewhere)."""
    return _reduce_detached(x, dist.ReduceOp.SUM)


@torch.no_grad()
def data_max_detached(x: torch.Tensor) -> torch.Tensor:
    """The largest ``x`` over the data axis, as ``data_sum_detached``."""
    return _reduce_detached(x, dist.ReduceOp.MAX)


def _reduce_detached(x: torch.Tensor, op) -> torch.Tensor:
    x = x.detach()
    if batch_size_factor() == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, op=op, group=stats_group())
    return y


def replicate(module: nn.Module, src: int = 0) -> nn.Module:
    """Broadcast every parameter and buffer from rank ``src`` to every rank."""
    if process_count() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src)
    return module


# --------------------------------------------------------- tensor parallel
def _kernel_layout(module: nn.Module, leaf: str) -> Optional[Tuple[int, int]]:
    """(axis, blocks) of a parameter whose JAX leaf is a Dense or Conv
    kernel, whose output features lie on the port's axis 0 (the bridge
    transposes them there); an attention layer's in_proj_weight holds three
    kernels, q, k and v, one block each.  None for any other parameter, which
    the bridge keeps in JAX's layout."""
    if leaf == "in_proj_weight":               # (3 * d, d): q, k and v stacked
        return 0, 3
    if leaf == "weight" and isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return 0, 1
    return None


def tp_leaf_spec(x: torch.Tensor, n_model: int, module: Optional[nn.Module] = None,
                 leaf: str = "") -> Tuple:
    """The tensor-parallel placement of one parameter, by JAX's rule: a leaf
    of two or more dimensions shards its output features (JAX's last axis)
    over ``model`` where they split evenly with at least 2 a shard; anything
    else is replicated.  Returns a spec like ``PartitionSpec``'s: one entry
    per dimension of the port's tensor, ``MODEL_AXIS`` at the sharded axis,
    or () for a replicated one.  ``module`` and ``leaf`` say where the
    output features lie (``_kernel_layout``); without them, the last axis."""
    layout = _kernel_layout(module, leaf) if module is not None else None
    axis, blocks = layout if layout else (x.dim() - 1, 1)
    features = x.shape[axis] // blocks if x.dim() else 0
    if x.dim() >= 2 and features % n_model == 0 and features >= 2 * n_model:
        return tuple(MODEL_AXIS if i == axis else None for i in range(x.dim()))
    return ()


class TensorParallel:
    """The model-axis shards of a model's large matrices and of their AdamW
    moments (``shard_state_tp``).  Between steps each rank keeps its shard of
    every parameter ``tp_leaf_spec`` shards; ``gather`` all-gathers the full
    parameters over ``model`` before the forward; ``scatter`` cuts each
    full parameter and its (data-reduced) gradient back to the shard, on
    which the optimizer steps (AdamW is elementwise, so stepping shards is
    exact)."""

    def __init__(self, model: nn.Module):
        self.group = axis_group(MODEL_AXIS)
        self.n, self.index = axis_size(MODEL_AXIS), axis_index(MODEL_AXIS)
        self.sharded: List[Tuple[nn.Parameter, int, int]] = []
        for mod in model.modules():
            for leaf, p in mod.named_parameters(recurse=False):
                spec = tp_leaf_spec(p, self.n, mod, leaf)
                if spec and p.requires_grad:
                    axis, blocks = _kernel_layout(mod, leaf) or (p.dim() - 1, 1)
                    self.sharded.append((p, axis, blocks))
        self.device = next(model.parameters()).device
        self.shards_held = False

    def _blocks(self, t: torch.Tensor, axis: int, blocks: int) -> torch.Tensor:
        shape = list(t.shape)
        return t.reshape(shape[:axis] + [blocks, shape[axis] // blocks] + shape[axis + 1:])

    def _cut(self, t: torch.Tensor, axis: int, blocks: int) -> torch.Tensor:
        v = self._blocks(t, axis, blocks)
        k = v.shape[axis + 1] // self.n
        part = v.narrow(axis + 1, self.index * k, k)
        shape = list(t.shape)
        shape[axis] //= self.n
        return part.reshape(shape).contiguous()

    @torch.no_grad()
    def scatter(self) -> None:
        """Full parameters (and gradients) -> this rank's shards."""
        for p, axis, blocks in self.sharded:
            p.data = self._cut(p.data, axis, blocks)
            if p.grad is not None:
                p.grad = self._cut(p.grad, axis, blocks)
        self.shards_held = True

    @torch.no_grad()
    def gather(self) -> None:
        """This rank's shards -> the full parameters, over ``model``."""
        if not self.shards_held:
            return
        for p, axis, blocks in self.sharded:
            parts = [torch.empty_like(p.data) for _ in range(self.n)]
            dist.all_gather(parts, p.data.contiguous(), group=self.group)
            parts = [self._blocks(t, axis, blocks) for t in parts]
            full = torch.cat(parts, dim=axis + 1)
            shape = list(p.shape)
            shape[axis] *= self.n
            p.data = full.reshape(shape)
            p.grad = None
        self.shards_held = False

    def sharded_ids(self) -> set:
        return {id(p) for p, _, _ in self.sharded}


def shard_state_tp(step) -> TensorParallel:
    """Place a ``TrainStep``'s model and optimizer state by ``tp_leaf_spec``
    over the active model axis (``make_mesh_2d``): each rank keeps its shard
    of every sharded parameter, and the optimizer's moments, made on the
    first step, take the shard's shape."""
    tp = TensorParallel(step.model)
    tp.scatter()
    step.tp = tp
    return tp


# ---------------------------------------------------------------- processes
def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(backend: str, init_method: str, world_size: int, rank: int,
               timeout_s: float = 600.0) -> None:
    """Join the default process group and activate the data axis over it."""
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    make_mesh()


def init_from_env(device_type: str) -> Optional[int]:
    """Join the group a ``torchrun``-style environment describes (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), as the JAX command joins
    ``jax.distributed`` under JAX_PROCESS_COUNT; on CUDA the process takes
    ``cuda:LOCAL_RANK`` first.  Returns the local rank, or None where the
    environment names no group."""
    if "WORLD_SIZE" not in os.environ or (dist.is_available() and dist.is_initialized()):
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    init_group(default_backend(device_type), "env://", world, rank)
    return local_rank


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    _AXES.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _worker(local_rank: int, main_fn: Callable, world_size: int, num_gpus: int,
            machine_rank: int, dist_url: str, args: tuple, device_type: str,
            device_map: Optional[Sequence[str]], backend: str) -> None:
    if device_type == "cpu":                    # the machine's cores shared out
        torch.set_num_threads(max(1, torch.get_num_threads() // num_gpus))
    if device_map is not None:
        device = torch.device(device_map[local_rank])
    elif device_type == "cuda":
        device = torch.device("cuda", local_rank)
    else:
        device = torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_group(backend, dist_url, world_size, machine_rank * num_gpus + local_rank)
    try:
        main_fn(device, *args)
    finally:
        shutdown()


def launch(main_fn: Callable, num_gpus: int, num_machines: int = 1, machine_rank: int = 0,
           dist_url: str = "auto", device: str = "cuda", args: tuple = (),
           device_map: Optional[Sequence[str]] = None, timeout_s: Optional[float] = None) -> None:
    """Run ``main_fn(device, *args)`` in ``num_gpus`` processes on this
    machine, each a rank of a group of ``num_gpus * num_machines`` (global
    rank ``machine_rank * num_gpus + local_rank``), as detectron2's
    ``launch``.  One process alone runs in this one, outside any group.
    ``device``: "cuda" (rank i on ``cuda:i``, NCCL) or "cpu" (gloo);
    ``device_map``: the device of each local rank instead, over gloo, which
    reduces CUDA tensors through the host, so two ranks may share a card.
    ``dist_url``: the rendezvous (``tcp://host:port``, ``file://path``);
    "auto" picks a free local port for one machine.  The kernel library is
    built here, before the workers start, so that they only load it.  A
    worker that raises or exits non-zero fails the call; with ``timeout_s``,
    so do workers still running after that many seconds (they are killed)."""
    world = num_gpus * num_machines
    if world == 1:
        dev = torch.device(device_map[0] if device_map else ("cuda:0" if device == "cuda"
                                                               else "cpu"))
        main_fn(dev, *args)
        return
    if dist_url == "auto":
        if num_machines != 1:
            raise ValueError("--dist-url auto serves one machine; give the first machine's URL")
        dist_url = f"tcp://127.0.0.1:{_free_port()}"
    device_type = torch.device(device_map[0]).type if device_map else device
    if device_type == "cuda":
        from ..ops.build import build_library

        build_library()
    backend = "gloo" if device_map else default_backend(device_type)
    ctx = torch.multiprocessing.start_processes(
        _worker, nprocs=num_gpus, start_method="spawn", join=False,
        args=(main_fn, world, num_gpus, machine_rank, dist_url, args, device_type, device_map,
              backend))
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the {num_gpus} workers did not finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
