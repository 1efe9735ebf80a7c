"""Process groups for the PyTorch port's multi-process tests: ``run_ranks``
spawns W processes, each a rank of a gloo group on the CPU (rendezvous by a
file under the test's temporary directory, so parallel test workers never
share a port), runs a worker function in each and returns what each
returned.  The workers below import only torch, numpy and the port, never
JAX: the spawned interpreters import this module, and the parent computes
the JAX references.  Each child runs one thread.
"""

from __future__ import annotations

import os
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from autofocusformermod_torch.models.layers import set_dropout_generator

JOIN_TIMEOUT_S = 150.0


def _entry(rank: int, fn: Callable, world: int, rendezvous: str, out_dir: str, args: tuple):
    torch.set_num_threads(1)
    from autofocusformermod_torch.parallel import mesh

    out = Path(out_dir) / f"rank{rank}.pt"
    try:
        mesh.init_group("gloo", f"file://{rendezvous}", world, rank, timeout_s=JOIN_TIMEOUT_S)
        result = fn(*args)
        torch.save({"ok": True, "result": result}, out)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise
    finally:
        mesh.shutdown()


def run_ranks(fn: Callable, world: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT_S
              ) -> List:
    """``fn(*args)`` in ``world`` gloo ranks; -> each rank's result, in rank
    order.  A rank that raises, exits non-zero or outlives ``timeout``
    seconds fails the call (the others are killed)."""
    tmp = Path(tmp_path) / f"ranks_{fn.__name__}_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    env = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ctx = torch.multiprocessing.start_processes(
            _entry, nprocs=world, join=False, start_method="spawn",
            args=(fn, world, str(tmp / "rendezvous"), str(tmp), args))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: the ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for rank in range(world):
        rec = torch.load(tmp / f"rank{rank}.pt", weights_only=False)
        if not rec["ok"]:
            raise RuntimeError(f"rank {rank} failed:\n{rec['error']}")
        results.append(rec["result"])
    return results


class Replay:
    """A ``Draw`` that hands out the given arrays in order, checking shapes:
    uint32 arrays as seeds, float32 arrays as uniforms
    (``test_torch_sampler.Replay``)."""

    def __init__(self, arrays):
        self.it = iter(arrays)

    def __call__(self, shape):
        a = np.asarray(next(self.it))
        assert a.dtype == np.float32 and tuple(a.shape) == tuple(shape), (a.dtype, a.shape, shape)
        return torch.from_numpy(a.copy())

    def seeds(self, count):
        a = np.asarray(next(self.it))
        assert a.dtype == np.uint32 and a.shape == (count,), (a.dtype, a.shape, count)
        return torch.from_numpy(a.astype(np.int64))


def _tensors(batch: Dict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------------------ workers
def batchnorm_worker(x: np.ndarray, weight: np.ndarray, bias: np.ndarray, dy: np.ndarray) -> Dict:
    """FlaxBatchNorm2d in train mode on this rank's rows of x (b, c, h, w):
    its output rows, the gradient of sum(y * dy) at its input rows, and the
    running statistics."""
    from autofocusformermod_torch.models.layers import FlaxBatchNorm2d
    from autofocusformermod_torch.parallel import mesh

    bn = FlaxBatchNorm2d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xs = mesh.shard_batch({"x": torch.from_numpy(x), "dy": torch.from_numpy(dy)})
    xin = xs["x"].clone().requires_grad_(True)
    with mesh.global_batch():                   # as inside a training step
        y = bn(xin)
    (y * xs["dy"]).sum().backward()
    return {"y": y.detach(), "dx": xin.grad, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone(), "dweight": bn.weight.grad, "dbias": bn.bias.grad}


def _criterion_rank(nn_rank):
    from autofocusformermod_torch.losses import criterion

    if nn_rank is not None:
        criterion.NN_RANK_UNCERTAINTY = nn_rank


def step_worker(cfg, state_dict: Dict, batch: Dict, draws, nn_rank=None, steps: int = 1,
                seed: int = 7) -> Dict:
    """``TrainStep`` of the model ``cfg`` builds, from ``state_dict``, on this
    rank's rows of the global ``batch``: ``steps`` steps, the criterion's
    draws replayed from ``draws`` (the global batch's) or, where ``draws`` is
    None, from a generator seeded ``seed``.  -> the first step's loss terms,
    gradients (each step's model gradients before clipping) and BatchNorm
    statistics, every step's metrics, and the final parameters and buffers."""
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.registry import build_model
    from autofocusformermod_torch.parallel import mesh

    _criterion_rank(nn_rank)
    model = build_model(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    gens = {"dropout": torch.Generator().manual_seed(seed + 2)}
    set_dropout_generator(model, gens["dropout"])
    if hasattr(model, "set_oracle_generator"):
        gens["oracle"] = torch.Generator().manual_seed(seed + 3)
        model.set_oracle_generator(gens["oracle"])
    step = TrainStep(model, cfg)
    local = mesh.shard_batch(_tensors(batch))
    draw = Replay(draws) if draws is not None else device_draw(
        torch.Generator().manual_seed(seed + 1))
    out = {"metrics": []}
    for i in range(steps):
        total, losses, matched = step.loss_and_grads(local, draw)
        if i == 0:
            out["total"] = total.item()
            out["losses"] = {k: v.item() for k, v in losses.items()}
            out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
            out["stats"] = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
            out["matched"] = [m.clone() for m in matched]
        grad_norm = step.apply_gradients()
        out["metrics"].append({"total_loss": total.item(), **{k: v.item() for k, v in
                                                               losses.items()},
                               "grad_norm": grad_norm.item()})
    out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    out["buffers"] = {n: b.clone() for n, b in model.named_buffers()}
    return out


def merge_worker(kind: str, samples: List, num_classes: int, things=()) -> Dict:
    """This rank's shard of ``samples`` (every W-th, as ``eval_loader``
    shards a test set) into a semantic or panoptic evaluator, merged over
    the ranks; -> the merged metrics."""
    from autofocusformermod_torch.evaluation import PanopticEvaluator, SemSegEvaluator
    from autofocusformermod_torch.evaluation.distributed import merge_across_processes
    from autofocusformermod_torch.parallel import mesh

    ev = (SemSegEvaluator(num_classes) if kind == "sem_seg"
          else PanopticEvaluator(set(things), num_classes))
    for sample in samples[mesh.axis_index()::mesh.axis_size()]:
        ev.process(*sample)
    merge_across_processes(ev)
    return ev.evaluate()


def register_datasets(datasets) -> None:
    """Register semantic sets in this process: [(name, image root, label
    root, class names)]."""
    from autofocusformermod_torch.data.catalog import DatasetCatalog
    from autofocusformermod_torch.data.datasets import register_sem_seg

    for name, images, labels, classes in datasets:
        DatasetCatalog.remove(name)
        register_sem_seg(name, images, labels, classes)


def trainer_test_worker(cfg, datasets, state_dict: Dict) -> Dict:
    """``Trainer(cfg).test()`` on the CPU over the registered sets, the
    model's weights from ``state_dict``."""
    from autofocusformermod_torch.engine.train import Trainer

    register_datasets(datasets)
    trainer = Trainer(cfg, torch.device("cpu"))
    trainer.model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return trainer.test()


def train_net_worker(argv: List[str]) -> Dict:
    """The train_net command's run on the CPU as a rank of the group:
    -> the step it started from, its parameters and its AdamW step count."""
    from autofocusformermod_torch import train_net

    args = train_net.default_argument_parser().parse_args(argv)
    trainer = train_net.run(torch.device("cpu"), args, train_net.setup(args))
    opt = trainer.step_fn.optimizer
    steps = {int(s["step"]) for s in opt.state.values() if "step" in s}
    return {"start_step": trainer.start_step, "adam_steps": steps,
            "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()}}


def tp_step_worker(cfg, state_dict: Dict, batch: Dict, n_model: int, steps: int = 2) -> Dict:
    """``step_worker``'s steps on a (W / n_model x n_model) mesh with the
    large matrices sharded over ``model`` (n_model 1: data parallel alone);
    -> each step's metrics, the full parameters after the steps, and the
    shapes this rank held between the steps."""
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.registry import build_model
    from autofocusformermod_torch.parallel import mesh

    if n_model > 1:
        mesh.make_mesh_2d(mesh.process_count() // n_model, n_model)
    model = build_model(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    set_dropout_generator(model, torch.Generator().manual_seed(9))
    step = TrainStep(model, cfg)
    if n_model > 1:
        mesh.shard_state_tp(step)
    local = mesh.shard_batch(_tensors(batch))
    draw = device_draw(torch.Generator().manual_seed(8))
    metrics = [{k: float(v) for k, v in step(local, draw).items()} for _ in range(steps)]
    held = {n: tuple(p.shape) for n, p in model.named_parameters()}
    moments = {n: tuple(step.optimizer.state[p]["exp_avg"].shape)
               for n, p in model.named_parameters() if p in step.optimizer.state}
    if step.tp is not None:
        step.tp.gather()
    return {"metrics": metrics, "held": held, "moments": moments,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def replicate_worker() -> Dict:
    """A module made from this rank's own seed, replicated from rank 0, and
    this rank's rows of a global batch of four."""
    from autofocusformermod_torch.parallel import mesh

    torch.manual_seed(100 + mesh.process_index())
    module = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    module[1].running_mean.normal_()
    mesh.replicate(module)
    batch = mesh.shard_batch({"x": torch.arange(8).reshape(4, 2), "names": list("abcd")})
    return {"state": {k: v.clone() for k, v in module.state_dict().items()}, "batch": batch}
