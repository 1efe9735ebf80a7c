"""The training step: train-mode forward -> Hungarian matching + criterion ->
backward -> full-model clipping -> AdamW update.

Counterpart of ``autofocusformermod_tpu/parallel/train_step.py`` on one
device: ``make_train_step`` for a MaskFormer, and
``make_maskfiner_train_step`` for the MaskFiner cascade, whose criterion
runs over the last stage's outputs and every stage's rounds (19 outputs
for MaskFiner-Mini, at one mask size per stage) with the loss weights of
MODEL.MASK_FINER and the classes of MODEL.MR_SEM_SEG_HEAD, as the JAX
benchmark and the upstream meta-architecture read them.  The
OracleTeacher cascades (MaskFinerOracleTeacher, MaskFinerOracle and the BB
and SW forms) also take the label map as ``sem_seg_gt`` and add
MODEL.MASK_FINER.UPSAMPLING_WEIGHT times ``loss_upsampling``, the mean
squared error of the upsampling scores against the GT-edge oracle
(``make_maskfiner_train_step(needs_sem_seg_gt=True)``).  A MaskFormerML
adds MODEL.MASK_FORMER.METALOSS_WEIGHT times ``meta_loss``
(``models/mrml.py:compute_meta_loss`` at the smallest MRML patch), as
``make_train_step(metaloss_weight=...)``.
``TrainStep(model, cfg)`` builds the optimizer; ``step(batch, draw)``
takes one step and returns the metrics the JAX step returns:
``total_loss``, every loss term and ``grad_norm`` (before clipping).
``draw`` supplies the criterion's randomness
(``losses.criterion.device_draw`` of a ``torch.Generator`` by default).
A model built under SOLVER.AMP.ENABLED runs its forward on the bf16 view
of the fp32 master parameters (``parallel/precision.py:apply``; one that
its build function keeps fp32, MaskFormerSwin, stays fp32), hands fp32 outputs to the
criterion, the matcher and the upsampling and meta losses, and gradients,
AdamW state and BatchNorm statistics stay fp32.

Data parallelism (``parallel/mesh.py``): under an active data axis the
model and its loss run as one module inside
``DistributedDataParallel`` (buffers not broadcast: the BatchNorm
statistics are already global; unused parameters searched for, since some
meta-architectures leave parameters without a gradient, on one rank or on
all).  Each rank's loss is its share of the global batch's loss (the
criterion's terms by their global normalisers, the upsampling and meta
losses, means over equal local batches, by 1 / W); the backward runs on W
times the share, so the gradients DDP averages are those of the global
loss, and the clipping sees the same gradients on every rank.  The loss
terms returned are summed over the axis: every rank reports the global
values.  Under a (data x model) mesh, ``mesh.shard_state_tp`` keeps each
rank's shard of the large matrices and of their AdamW moments; the step
gathers them before the forward and cuts the reduced gradients back to the
shards, on which AdamW steps.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..losses.criterion import Draw, set_criterion
from ..models.mrml import compute_meta_loss
from ..models.oracle import upsampling_mse_loss
from ..models.registry import meta_architecture
from ..parallel import mesh, precision
from .optimizer import build_optimizer, clip_by_global_norm_, global_norm


def device_masks(batch: Dict) -> torch.Tensor:
    """The (b, t, H, W) float target masks: the batch's own ``masks`` where
    it ships them (panoptic and instance batches), else made on the batch's
    device from the sem_seg map and the per-slot labels: a slot's mask is
    ``sem_seg_map == label``, gated by ``valid`` so padded slots (label 0)
    cannot alias class 0."""
    if "masks" in batch:
        return batch["masks"].float()
    sem = batch["sem_seg_map"].long()
    eq = sem[:, None] == batch["labels"].long()[:, :, None, None]
    return (eq & batch["valid"][:, :, None, None]).float()


def needs_sem_seg_gt(cfg) -> bool:
    """Whether the model takes the label map in training: the OracleTeacher
    cascades (MaskFinerOracle, MaskFinerOracleTeacher and its BB and SW
    forms), whose upsampling scores are supervised by the GT-edge oracle."""
    return meta_architecture(cfg).startswith("MaskFinerOracle")


def criterion_config(cfg) -> Tuple:
    """(the node of the loss weights and point counts, the class count) of
    the configured meta-architecture: MODEL.MASK_FINER and
    MODEL.MR_SEM_SEG_HEAD for every MaskFiner cascade, else
    MODEL.MASK_FORMER and MODEL.SEM_SEG_HEAD."""
    if meta_architecture(cfg).startswith("MaskFiner"):
        return cfg.MODEL.MASK_FINER, cfg.MODEL.MR_SEM_SEG_HEAD.NUM_CLASSES
    return cfg.MODEL.MASK_FORMER, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES


class _ModelWithLoss(nn.Module):
    """The model and its training loss as one module, whose forward returns
    (total, loss terms, matches): DistributedDataParallel wraps this, so
    the search for unused parameters starts from the loss."""

    def __init__(self, step: "TrainStep"):
        super().__init__()
        self.model = step.model
        self.loss = step.local_loss

    def forward(self, batch: Dict, draw: Draw):
        return self.loss(batch, draw)


class TrainStep:
    """One optimizer step of a MaskFormer or a MaskFiner cascade on one
    batch: ``step(batch, draw)``.

    batch: {'image': (b, H, W, 3) uint8 or float RGB, 'sem_seg_map': (b, H,
    W) int (255: void), 'labels': (b, t) int, 'valid': (b, t) bool}, all on
    the model's device; a batch that ships 'masks' (b, t, H, W) is trained
    on those."""

    def __init__(self, model: nn.Module, cfg):
        self.model = model
        self.optimizer, self.scheduler = build_optimizer(cfg, model)
        mf, self.num_classes = criterion_config(cfg)
        self.criterion = dict(
            eos_coef=mf.NO_OBJECT_WEIGHT, class_weight=mf.CLASS_WEIGHT,
            mask_weight=mf.MASK_WEIGHT, dice_weight=mf.DICE_WEIGHT,
            num_points=mf.TRAIN_NUM_POINTS, oversample_ratio=mf.OVERSAMPLE_RATIO,
            importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO)
        self.with_sem_seg_gt = needs_sem_seg_gt(cfg)
        self.upsampling_weight = float(mf.UPSAMPLING_WEIGHT) if self.with_sem_seg_gt else 0.0
        ml = meta_architecture(cfg) == "MaskFormerML"
        self.metaloss_weight = float(mf.METALOSS_WEIGHT) if ml else 0.0
        self.ml_min_patch_size = min(cfg.MODEL.MRML.PATCH_SIZES) if ml else 0
        clip = cfg.SOLVER.CLIP_GRADIENTS
        full = clip.ENABLED and clip.CLIP_TYPE == "full_model" and clip.CLIP_VALUE > 0
        self.clip_value = clip.CLIP_VALUE if full else None
        self.world = mesh.axis_size()
        self.tp = None                     # mesh.shard_state_tp sets it
        self.ddp = None
        if mesh.distributed():
            from torch.nn.parallel import DistributedDataParallel

            with warnings.catch_warnings():
                # newer releases rename broadcast_buffers; False is still the
                # way to keep them from being synchronised at all
                warnings.filterwarnings("ignore", message=".*broadcast_buffers.*",
                                        category=FutureWarning)
                self.ddp = DistributedDataParallel(
                    _ModelWithLoss(self), process_group=mesh.axis_group(mesh.DATA_AXIS),
                    broadcast_buffers=False, find_unused_parameters=True)

    def parameters(self) -> List[nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def local_loss(self, batch: Dict, draw: Draw) -> Tuple[torch.Tensor, Dict, list]:
        """Forward and criterion on this rank's rows: (its share of the
        total, of each loss term, the matched query per target of each
        layer)."""
        if self.with_sem_seg_gt:
            outputs = precision.apply(self.model, batch["image"], batch["sem_seg_map"])
        else:
            outputs = precision.apply(self.model, batch["image"])
        targets = {"labels": batch["labels"], "masks": device_masks(batch),
                   "valid": batch["valid"]}
        total, losses, matched = set_criterion(outputs, targets, self.num_classes, draw,
                                               **self.criterion)
        if outputs.get("upsampling_preds"):
            losses["loss_upsampling"] = upsampling_mse_loss(outputs["upsampling_preds"],
                                                            outputs["upsampling_oracles"]
                                                            ) / self.world
            total = total + self.upsampling_weight * losses["loss_upsampling"]
        if self.metaloss_weight > 0 and "metaloss_preds" in outputs:
            losses["meta_loss"] = compute_meta_loss(outputs, targets["labels"], targets["masks"],
                                                    targets["valid"], self.ml_min_patch_size
                                                    ) / self.world
            total = total + self.metaloss_weight * losses["meta_loss"]
        return total, losses, matched

    def loss_and_grads(self, batch: Dict, draw: Draw) -> Tuple[torch.Tensor, Dict, list]:
        """Forward, criterion and backward; every parameter's ``.grad`` is
        set (zeros where no loss reaches it, as jax.grad gives), to the
        gradient of the global batch's loss under a data axis.  Returns
        (total, loss terms, matched query per target of each layer)."""
        self.model.train()
        if self.tp is not None:
            self.tp.gather()
        with mesh.global_batch():
            total, losses, matched = (self.ddp or self.local_loss)(batch, draw)
        self.model.zero_grad(set_to_none=True)
        (total * self.world if self.world > 1 else total).backward()
        for p in self.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.world > 1:
            with mesh.global_batch():
                summed = mesh.data_sum_detached(torch.stack([total.detach().float()] + [
                    v.detach().float() for v in losses.values()]))
            total = summed[0]
            losses = dict(zip(losses, summed[1:]))
        return total.detach(), {k: v.detach() for k, v in losses.items()}, matched

    def apply_gradients(self) -> torch.Tensor:
        """Clip the whole model's gradients, take the AdamW step and advance
        the schedule.  Returns the global gradient norm before clipping."""
        if self.tp is not None:
            self.tp.scatter()
        grads = [p.grad for p in self.parameters()]
        norm = None if self.tp is None else self.tp_global_norm()
        if self.clip_value is None:
            grad_norm = global_norm(grads) if norm is None else norm
        else:
            grad_norm = clip_by_global_norm_(grads, self.clip_value, norm)
        self.optimizer.step()
        self.scheduler.step()
        return grad_norm.detach()

    def tp_global_norm(self) -> torch.Tensor:
        """The global gradient norm over the shards: each shard counted once
        (its squares summed over ``model``), each replicated leaf once."""
        sharded = self.tp.sharded_ids()
        sq = [(p.grad.float() ** 2).sum() for p in self.parameters() if id(p) in sharded]
        rep = [(p.grad.float() ** 2).sum() for p in self.parameters() if id(p) not in sharded]
        part = torch.stack(sq).sum() if sq else torch.zeros((), device=self.tp.device)
        torch.distributed.all_reduce(part, group=mesh.axis_group(mesh.MODEL_AXIS))
        return torch.sqrt(part + (torch.stack(rep).sum() if rep else 0.0))

    def __call__(self, batch: Dict, draw: Draw) -> Dict[str, torch.Tensor]:
        total, losses, _ = self.loss_and_grads(batch, draw)
        return {"total_loss": total, **losses, "grad_norm": self.apply_gradients()}
