"""Seeded synthetic semantic-segmentation batches, for running the trainer
where no dataset is installed: random uint8 images and blocky label maps,
in the layout the semantic dataset mapper hands to the training step.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from ..config import train_image_size
from ..parallel import mesh


def synthetic_batch(generator: torch.Generator, device, batch: int, size: Tuple[int, int],
                    slots: int, num_classes: int) -> Dict[str, torch.Tensor]:
    """{'image' (b, H, W, 3) uint8, 'sem_seg_map' (b, H, W) uint8, 'labels'
    (b, slots) int64, 'valid' (b, slots) bool} on ``device``: a 16x16 grid of
    cells over each image, 8-12 classes each (as many as the grid and the
    class count allow), labels padded to ``slots`` target slots as the
    semantic mapper pads them.  ``generator`` is a CPU generator."""
    h, w = size
    gh, gw = min(16, h), min(16, w)
    if h % gh or w % gw:
        raise ValueError(f"image size {size} must be a multiple of the {gh}x{gw} cell grid")
    images = torch.randint(0, 256, (batch, h, w, 3), generator=generator, dtype=torch.uint8)
    sem = torch.zeros((batch, h, w), dtype=torch.uint8)
    labels = torch.zeros((batch, slots), dtype=torch.long)
    valid = torch.zeros((batch, slots), dtype=torch.bool)
    hi = min(12, num_classes, slots, gh * gw)
    lo = min(8, hi)
    for i in range(batch):
        k = int(torch.randint(lo, hi + 1, (1,), generator=generator))
        classes = torch.randperm(num_classes, generator=generator)[:k]
        cells = classes[torch.randint(0, k, (gh * gw,), generator=generator)]
        cells[:k] = classes                                # every class present
        cells = cells[torch.randperm(gh * gw, generator=generator)].reshape(gh, gw)
        sem[i] = cells.repeat_interleave(h // gh, 0).repeat_interleave(w // gw, 1)
        present = torch.unique(sem[i]).long()
        labels[i, :len(present)] = present
        valid[i, :len(present)] = True
    return {"image": images.to(device), "sem_seg_map": sem.to(device),
            "labels": labels.to(device), "valid": valid.to(device)}


def synthetic_batches(cfg, device, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """An endless stream of batches for ``cfg`` (SOLVER.IMS_PER_BATCH images
    of the training size, ``config.train_image_size``, labels among the
    classes the model's criterion has: MR_SEM_SEG_HEAD's for a MaskFiner
    cascade, whose COCO-panoptic yamls leave SEM_SEG_HEAD at the default
    150).  The batch of a step depends on cfg.SEED and the
    step alone, so a resumed run, started at its step, sees the batches the
    uninterrupted run saw.  Under a data axis of several processes each
    yields its rows of that global batch (``mesh.shard_batch``)."""
    from ..engine.train_step import criterion_config

    num_classes = criterion_config(cfg)[1]
    step = start_step
    while True:
        gen = torch.Generator().manual_seed(cfg.SEED * 1_000_003 + step)
        batch = synthetic_batch(gen, "cpu", cfg.SOLVER.IMS_PER_BATCH, train_image_size(cfg),
                                cfg.TPU.MAX_GT_INSTANCES, num_classes)
        yield {k: v.to(device) for k, v in mesh.shard_batch(batch).items()}
        step += 1
