"""The training step: train-mode forward -> Hungarian matching + criterion ->
backward -> full-model clipping -> AdamW update.

Counterpart of ``autofocusformermod_tpu/parallel/train_step.py``
(``make_train_step``) on one device, fp32.  ``TrainStep(model, cfg)``
builds the optimizer; ``step(batch, draw)`` takes one step and returns the metrics the JAX
step returns: ``total_loss``, every loss term and ``grad_norm`` (before
clipping).  ``draw`` supplies the criterion's randomness
(``losses.criterion.device_draw`` of a ``torch.Generator`` by default).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..losses.criterion import Draw, set_criterion
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


class TrainStep:
    """One optimizer step of a MaskFormer on one batch: ``step(batch, draw)``.

    batch: {'image': (b, H, W, 3) uint8 or float RGB, 'sem_seg_map': (b, H,
    W) int, 'labels': (b, t) int, 'valid': (b, t) bool}, all on the model's
    device; a batch that ships 'masks' (b, t, H, W) is trained on those."""

    def __init__(self, model: nn.Module, cfg):
        self.model = model
        self.optimizer, self.scheduler = build_optimizer(cfg, model)
        mf = cfg.MODEL.MASK_FORMER
        self.num_classes = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        self.criterion = dict(
            eos_coef=mf.NO_OBJECT_WEIGHT, class_weight=mf.CLASS_WEIGHT,
            mask_weight=mf.MASK_WEIGHT, dice_weight=mf.DICE_WEIGHT,
            num_points=mf.TRAIN_NUM_POINTS, oversample_ratio=mf.OVERSAMPLE_RATIO,
            importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO)
        clip = cfg.SOLVER.CLIP_GRADIENTS
        full = clip.ENABLED and clip.CLIP_TYPE == "full_model" and clip.CLIP_VALUE > 0
        self.clip_value = clip.CLIP_VALUE if full else None

    def parameters(self) -> List[nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def loss_and_grads(self, batch: Dict, draw: Draw) -> Tuple[torch.Tensor, Dict, list]:
        """Forward, criterion and backward; every parameter's ``.grad`` is
        set (zeros where no loss reaches it, as jax.grad gives).  Returns
        (total, loss terms, matched query per target of each layer)."""
        self.model.train()
        outputs = self.model(batch["image"])
        targets = {"labels": batch["labels"], "masks": device_masks(batch),
                   "valid": batch["valid"]}
        total, losses, matched = set_criterion(outputs, targets, self.num_classes, draw,
                                               **self.criterion)
        self.model.zero_grad(set_to_none=True)
        total.backward()
        for p in self.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return total.detach(), {k: v.detach() for k, v in losses.items()}, matched

    def apply_gradients(self) -> torch.Tensor:
        """Clip the whole model's gradients, take the AdamW step and advance
        the schedule.  Returns the global gradient norm before clipping."""
        grads = [p.grad for p in self.parameters()]
        if self.clip_value is None:
            grad_norm = global_norm(grads)
        else:
            grad_norm = clip_by_global_norm_(grads, self.clip_value)
        self.optimizer.step()
        self.scheduler.step()
        return grad_norm.detach()

    def __call__(self, batch: Dict, draw: Draw) -> Dict[str, torch.Tensor]:
        total, losses, _ = self.loss_and_grads(batch, draw)
        return {"total_loss": total, **losses, "grad_norm": self.apply_gradients()}
