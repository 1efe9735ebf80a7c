"""Hungarian matching between queries and padded ground-truth targets.

Counterpart of ``autofocusformermod_tpu/losses/matcher.py`` (the point-
sampled class + mask + dice cost and the LSAP solve).  Targets are padded
to a fixed count per image with a validity mask; padded target columns get
a large constant cost, which leaves the assignment over the valid columns
optimal (the losses mask the padded matches out).  The LSAP runs in the
``lapjv`` kernel on CUDA tensors (``losses/lapjv.py``).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ..ops.dispatch import use_kernel
from .lapjv import hungarian_lsap, lapjv
from .point_sample import point_sample_shared_batch

_INVALID_COST = 1e8


def batch_sigmoid_ce_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Pairwise mean binary-CE cost: inputs (b, q, p) logits, targets (b, t, p)
    in {0, 1} -> (b, q, t).  sum_p softplus(x) - x.tgt, one matmul."""
    p = inputs.shape[-1]
    neg_sum = F.softplus(inputs).sum(-1)                              # (b, q)
    return (neg_sum[..., None] - torch.einsum("bqp,btp->bqt", inputs, targets)) / p


def batch_dice_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Pairwise dice cost: (b, q, p), (b, t, p) -> (b, q, t)."""
    inputs = torch.sigmoid(inputs)
    numerator = 2 * torch.einsum("bqp,btp->bqt", inputs, targets)
    denominator = inputs.sum(-1)[..., None] + targets.sum(-1)[:, None, :]
    return 1 - (numerator + 1) / (denominator + 1)


@torch.no_grad()
def matching_cost(pred_logits, pred_masks, tgt_labels, tgt_masks, tgt_valid, point_coords,
                  cost_class: float, cost_mask: float, cost_dice: float,
                  tgt_pts=None) -> torch.Tensor:
    """The class + mask + dice assignment cost (b, q, t), padded target
    columns at _INVALID_COST.

    pred_logits (b, q, nc+1); pred_masks (b, q, h, w); tgt_labels (b, t)
    int; tgt_masks (b, t, H, W); tgt_valid (b, t) bool; point_coords (b, p,
    2) random points shared by predictions and targets; tgt_pts optional
    (b, t, p) target values already sampled at point_coords."""
    b, q = pred_logits.shape[:2]
    t = tgt_labels.shape[1]
    if tgt_pts is None:
        H, W = tgt_masks.shape[-2:]
        tgt_pts = point_sample_shared_batch(
            tgt_masks.reshape(b, t, H * W).transpose(1, 2), H, W, point_coords)
    h, w = pred_masks.shape[-2:]
    out_pts = point_sample_shared_batch(
        pred_masks.reshape(b, q, h * w).transpose(1, 2), h, w, point_coords)  # (b, q, p)
    out_prob = torch.softmax(pred_logits, dim=-1)
    cc = -torch.gather(out_prob, 2, tgt_labels.long()[:, None, :].expand(b, q, t))
    tgt_pts = tgt_pts.to(out_pts.dtype)
    cm = torch.nan_to_num(batch_sigmoid_ce_cost(out_pts, tgt_pts), nan=1e6)
    cd = torch.nan_to_num(batch_dice_cost(out_pts, tgt_pts), nan=1e6)
    cost = cost_mask * cm + cost_class * cc + cost_dice * cd
    return torch.where(tgt_valid[:, None, :], cost, torch.full_like(cost, _INVALID_COST))


def solve_lsap(cost: torch.Tensor) -> torch.Tensor:
    """Solve the batched assignment: cost (b, q, t), t <= q -> (b, t) int64
    matched query per target slot (the ``lapjv`` kernel on CUDA tensors, its
    plain version on CPU tensors).  Stack the deep-supervision layers into
    ``b``: one solve then serves them all."""
    cost = cost.detach().float().contiguous()
    if cost.shape[2] > cost.shape[1]:
        raise ValueError(f"more targets than queries: {tuple(cost.shape)}")
    return lapjv(cost) if use_kernel(cost) else hungarian_lsap(cost)
