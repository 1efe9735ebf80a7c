"""Hungarian matching between queries and padded ground-truth targets.

Counterpart of ``autofocusformermod_tpu/losses/matcher.py`` (the point-
sampled class + mask + dice cost and the LSAP solve).  Targets are padded
to a fixed count per image with a validity mask; padded target columns get
a large constant cost, which leaves the assignment over the valid columns
optimal (the losses mask the padded matches out).  The LSAP runs in the
``lapjv`` kernel on CUDA tensors (``losses/lapjv.py``) unless
``set_matcher_backend`` forces another solver: "scipy" (scipy's
``linear_sum_assignment`` on the host, the JAX package's CPU default),
"jv" (the default's solver) or "auction" (``losses/auction.py``).

``matching_cost_downsample`` is the downsampled matcher's cost: the targets
max-pooled to the prediction's resolution (``max_pool_to``) and the mask
and dice costs dense over every prediction pixel, no points drawn.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from ..ops.dispatch import use_kernel
from .auction import auction_lsap
from .lapjv import hungarian_lsap, lapjv
from .point_sample import point_sample_shared_batch

_INVALID_COST = 1e8

# the LSAP solver: None (the default) and "jv" the lapjv kernel on CUDA
# tensors and its plain version on CPU tensors, "scipy" the host's
# linear_sum_assignment, "auction" the auction
BACKENDS = (None, "scipy", "jv", "auction")
_MATCHER_BACKEND: Optional[str] = None


def set_matcher_backend(backend: Optional[str]) -> None:
    """Force the LSAP solver of every later ``solve_lsap``: one of
    ``BACKENDS``."""
    global _MATCHER_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown matcher backend {backend!r}; known: {BACKENDS}")
    _MATCHER_BACKEND = backend


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


def max_pool_to(masks: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(b, t, H, W) -> (b, t, h, w): max over (H // h) x (W // w) windows."""
    H, W = masks.shape[-2:]
    kh, kw = H // out_hw[0], W // out_hw[1]
    if kh == 1 and kw == 1:
        return masks
    return F.max_pool2d(masks, (kh, kw), stride=(kh, kw))


@torch.no_grad()
def matching_cost_downsample(pred_logits, pred_masks, tgt_labels, tgt_masks, tgt_valid,
                             cost_class: float, cost_mask: float, cost_dice: float
                             ) -> torch.Tensor:
    """The downsampled matcher's class + mask + dice cost (b, q, t): the
    targets max-pooled to the predictions' (h, w), the mask and dice costs
    over all h * w pixels; padded target columns at _INVALID_COST."""
    b, q, h, w = pred_masks.shape
    t = tgt_labels.shape[1]
    out_flat = pred_masks.reshape(b, q, h * w)
    tgt_flat = max_pool_to(tgt_masks.float(), (h, w)).reshape(b, t, h * w).to(out_flat.dtype)
    out_prob = torch.softmax(pred_logits, dim=-1)
    cc = -torch.gather(out_prob, 2, tgt_labels.long()[:, None, :].expand(b, q, t))
    cost = (cost_mask * batch_sigmoid_ce_cost(out_flat, tgt_flat) + cost_class * cc
            + cost_dice * batch_dice_cost(out_flat, tgt_flat))
    return torch.where(tgt_valid[:, None, :], cost, torch.full_like(cost, _INVALID_COST))


def _lsap_host(cost: np.ndarray) -> np.ndarray:
    """scipy's assignment of each problem of (b, q, t) -> (b, t) int64; NaN
    and +inf read as _INVALID_COST, -inf as its negative."""
    from scipy.optimize import linear_sum_assignment

    out = np.zeros((cost.shape[0], cost.shape[2]), dtype=np.int64)
    for i, c in enumerate(cost):
        c = np.nan_to_num(c, nan=_INVALID_COST, posinf=_INVALID_COST, neginf=-_INVALID_COST)
        rows, cols = linear_sum_assignment(c)
        out[i, cols] = rows
    return out


def solve_lsap(cost: torch.Tensor) -> torch.Tensor:
    """Solve the batched assignment: cost (b, q, t), t <= q -> (b, t) int64
    matched query per target slot, by the solver ``set_matcher_backend``
    chose (by default the ``lapjv`` kernel on CUDA tensors, its plain
    version on CPU tensors); ``solve_lsap.solves_by_backend`` counts each
    solver's calls.  Stack the deep-supervision layers into ``b``: one
    solve then serves them all."""
    cost = cost.detach().float().contiguous()
    if cost.shape[2] > cost.shape[1]:
        raise ValueError(f"more targets than queries: {tuple(cost.shape)}")
    backend = _MATCHER_BACKEND or "jv"
    solve_lsap.solves_by_backend[backend] += 1
    if backend == "scipy":
        return torch.from_numpy(_lsap_host(cost.cpu().numpy())).to(cost.device)
    if backend == "auction":
        return auction_lsap(cost)
    return lapjv(cost) if use_kernel(cost) else hungarian_lsap(cost)


solve_lsap.solves_by_backend = {"scipy": 0, "jv": 0, "auction": 0}
