"""Entry points of the PyTorch port: the flagship model's eval forward, and
a multi-process dry run of the training step.

Counterpart of the JAX package's ``__graft_entry__.py``:

  entry()             -> (fn, example_args): ``fn(model, x)`` is the eval
                         forward of the flagship model (AFF-Mini + the
                         Mask2Former head, ADE20K 512x512 semantic
                         segmentation) -> (pred_logits, pred_masks); the
                         model (seeded random weights) and a (1, 512, 512, 3)
                         image, on the card unless ``device`` says otherwise.
  dryrun_multichip(n) -> one full training step (forward, Hungarian matching,
                         criterion, gradients, clipping, AdamW; matched by
                         scipy), then a second (the default solver), over n
                         gloo processes on the CPU, as JAX's
                         runs over n virtual CPU devices, on its tiny shapes;
                         a (n/2 x 2) data x model mesh for an even n >= 4.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from .config import get_cfg
from .config.defaults import add_maskformer2_config


def _flagship_cfg(num_classes: int = 150):
    """AFF-Mini (configs/ade20k/maskformer2_aff_mini_bs32_80k.yaml's widths)
    over the default tree, field by field as the JAX entry sets it."""
    cfg = get_cfg()
    add_maskformer2_config(cfg)
    cfg.MODEL.AFF.EMBED_DIM = [32, 128, 256, 384]
    cfg.MODEL.AFF.DEPTHS = [2, 2, 6, 2]
    cfg.MODEL.AFF.NUM_HEADS = [2, 4, 8, 16]
    cfg.MODEL.AFF.DROP_PATH_RATE = 0.0
    cfg.MODEL.AFF.MLP_RATIO = 2.0
    cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES = num_classes
    cfg.MODEL.MASK_FORMER.CLASS_WEIGHT = 2.0
    cfg.MODEL.MASK_FORMER.MASK_WEIGHT = 5.0
    cfg.MODEL.MASK_FORMER.DICE_WEIGHT = 5.0
    cfg.MODEL.MASK_FORMER.DEC_LAYERS = 10
    cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS = 6
    return cfg


def _forward(model, x):
    with torch.no_grad():
        out = model(x)
    return out["pred_logits"], out["pred_masks"]


def entry(device: Optional[str] = None):
    """(fn, (model, x)): the flagship's eval forward and its example input,
    the image JAX's entry draws (``np.random.default_rng(0)``, uniform in
    [0, 255)), on ``device`` (default: the first CUDA device)."""
    from .models.maskformer import init_random_weights, maskformer_from_config

    dev = torch.device(device or "cuda")
    model = maskformer_from_config(_flagship_cfg())
    init_random_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (1, 512, 512, 3))
                         .astype(np.float32)).to(dev)
    return _forward, (model, x)


def dryrun_cfg():
    """The JAX dry run's tiny model: 64x64 crops, 7 classes, one block a
    stage, one encoder layer, 4 decoder layers, 5 queries, the encoder
    layer's dropout at the default 0.1; its 64 criterion points, which JAX
    passes to ``make_train_step``, as TRAIN_NUM_POINTS."""
    cfg = _flagship_cfg(num_classes=7)
    cfg.MODEL.AFF.EMBED_DIM = [16, 24, 32, 40]
    cfg.MODEL.AFF.DEPTHS = [1, 1, 1, 1]
    cfg.MODEL.AFF.NUM_HEADS = [2, 2, 2, 2]
    cfg.MODEL.AFF.NBHD_SIZE = [8, 8, 8, 8]
    cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM = 32
    cfg.MODEL.SEM_SEG_HEAD.MASK_DIM = 32
    cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS = 1
    cfg.MODEL.MASK_FORMER.HIDDEN_DIM = 32
    cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES = 5
    cfg.MODEL.MASK_FORMER.NHEADS = 2
    cfg.MODEL.MASK_FORMER.DIM_FEEDFORWARD = 32
    cfg.MODEL.MASK_FORMER.DEC_LAYERS = 4
    cfg.MODEL.MASK_FORMER.TRAIN_NUM_POINTS = 64
    cfg.TPU.USE_PALLAS = False
    return cfg


def dryrun_mesh(n: int):
    """(n_data, n_model) of JAX's dry run: (n/2, 2) for an even n >= 4, else
    (n, 1)."""
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    return n // n_model, n_model


def dryrun_batch(n_data: int, size: int = 64, t: int = 3):
    """JAX's dry-run batch: one image a data rank, t targets of random
    masks, from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    b = n_data
    return {"image": rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32),
            "labels": rng.integers(0, 7, (b, t)).astype(np.int64),
            "masks": rng.integers(0, 2, (b, t, size, size)).astype(np.float32),
            "valid": np.ones((b, t), bool)}


def _dryrun_rank(device: torch.device, n: int) -> None:
    from .engine.train_step import TrainStep
    from .losses import matcher
    from .losses.criterion import device_draw
    from .models.layers import set_dropout_generator
    from .models.maskformer import init_random_weights, maskformer_from_config
    from .parallel import mesh

    n_data, n_model = dryrun_mesh(n)
    if n_model > 1:
        mesh.make_mesh_2d(n_data, n_model)
    cfg = dryrun_cfg()
    model = maskformer_from_config(cfg)
    init_random_weights(model, torch.Generator().manual_seed(0))
    set_dropout_generator(model, torch.Generator().manual_seed(2))
    step = TrainStep(model, cfg)
    if n_model > 1:
        mesh.shard_state_tp(step)
    batch = {k: torch.from_numpy(v) for k, v in dryrun_batch(n_data).items()}
    batch = mesh.shard_batch(batch)
    draw = device_draw(torch.Generator().manual_seed(1))
    losses = []
    # the first step's assignments by scipy on the host (the JAX package's
    # CPU default), the second's by the default solver, as JAX's second
    # step forces its "jv" backend
    for count, backend in ((1, "scipy"), (2, "jv")):
        before = dict(matcher.solve_lsap.solves_by_backend)
        matcher.set_matcher_backend(backend)
        try:
            metrics = step(batch, draw)
        finally:
            matcher.set_matcher_backend(None)
        solves = {k: n - before[k] for k, n in matcher.solve_lsap.solves_by_backend.items()}
        assert solves[backend] > 0 and sum(solves.values()) == solves[backend], (backend, solves)
        total = float(metrics["total_loss"])
        assert np.isfinite(total), f"non-finite loss at step {count}: {total}"
        assert step.scheduler.last_epoch == count, (step.scheduler.last_epoch, count)
        losses.append(total)
    if step.tp is not None:
        step.tp.gather()
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    every = [flat] if mesh.process_count() == 1 else None
    if every is None:
        every = [torch.empty_like(flat) for _ in range(mesh.process_count())]
        torch.distributed.all_gather(every, flat)
    for rank, other in enumerate(every):
        diff = float((other - flat).abs().max())
        assert diff <= 1e-6 * float(flat.abs().max()), (
            f"rank {rank}'s parameters differ from rank {mesh.process_index()}'s by {diff}")
    if mesh.is_main():
        print(f"dryrun_multichip({n}) OK: {n_data} x {n_model} mesh, loss={losses[0]:.4f} "
              f"(scipy) second step loss={losses[1]:.4f} (jv)", flush=True)


def dryrun_multichip(n_devices: int, dist_url: Optional[str] = None) -> None:
    """Two tiny full training steps over ``n_devices`` gloo processes on the
    CPU: (n/2 x 2) (data x model) for an even n >= 4, the large matrices and
    their AdamW moments sharded over ``model`` (``mesh.shard_state_tp``),
    else n data ranks.  Asserts a finite loss and the step count after each
    step, and the same parameters on every rank after both.  The first step
    matches by scipy on the host, the second by the default solver (the
    plain LSAP on the CPU), as JAX's run switches its backend to "jv"; each
    step asserts that its solver alone ran.  ``dist_url``: the rendezvous
    (default: a file in a new temporary directory)."""
    from .parallel import mesh

    with tempfile.TemporaryDirectory() as tmp:
        url = dist_url or f"file://{os.path.join(tmp, 'rendezvous')}"
        mesh.launch(_dryrun_rank, n_devices, dist_url=url, device="cpu", args=(n_devices,))


if __name__ == "__main__":
    dryrun_multichip(8)
