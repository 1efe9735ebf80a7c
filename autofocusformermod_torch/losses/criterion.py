"""SetCriterion: Hungarian-matched class loss plus point-sampled mask losses.

Counterpart of ``autofocusformermod_tpu/losses/criterion.py``
(``set_criterion``).  For the main output and every auxiliary output:

  - loss_ce   : cross-entropy over classes, weight ``eos_coef`` on no-object
  - loss_mask : sigmoid cross-entropy at uncertainty-sampled points
  - loss_dice : dice at the same points

normalized by the number of valid target masks.  As in the JAX package,
every layer is matched in one stacked LSAP solve, and every layer of one
mask resolution is sampled in one stacked pass.

All randomness comes from one ``Draw`` (``losses.point_sample.Draw``),
called in this order: ``draw((b, p, 2))``, the matcher's points, for each
layer in turn; then for each mask-resolution group, n = layers * b * t, with
the default nearest-tap ranking ``draw.seeds(2)`` (the candidates are hashed
from counters under these two seeds) and ``draw((n, p/4, 2))``, the random
remainder; with ``NN_RANK_UNCERTAINTY`` off ``draw((n, 3p, 2))``, the
candidates, and the same remainder.  The JAX package splits its key in the
same order (seeds from ``k1`` of the group's key, the remainder from ``k2``),
so a test can replay its draws.

Under a data axis of several processes (``parallel/mesh.py``) each rank
holds its rows of the global batch and the criterion is the global one, as
the JAX package's one program over that batch computes it: every draw is
the global batch's, of which the rank keeps its rows (``draw_rows``), the
ranking's counters are global, and the normalisers -- the number of valid
targets and each layer's class weights -- are summed over the axis
(detached).  Each rank's total and terms are then its share of the global
loss: the shares sum to it over the ranks.

``set_criterion_downsample`` is the downsampled criterion (no points
drawn): the targets max-pooled to each layer's mask resolution, matched by
``matching_cost_downsample`` and supervised dense over every pixel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from ..parallel import mesh
from .matcher import matching_cost, matching_cost_downsample, max_pool_to, solve_lsap
from .point_sample import (Draw, draw_rows, get_uncertain_point_coords_nn_ranked,
                           get_uncertain_point_coords_with_randomness, point_sample_auto,
                           point_sample_shared_batch)

# Rank the oversampled candidates with a one-tap nearest-cell read instead of
# the four-tap bilinear one (a selection heuristic only: the supervision stays
# at continuous points).  Off, the reference's exact sampler runs.
NN_RANK_UNCERTAINTY = True


def _uncertain_coords(draw, src_flat, num_points, oversample_ratio, importance_sample_ratio,
                      layout):
    fn = (get_uncertain_point_coords_nn_ranked if NN_RANK_UNCERTAINTY
          else get_uncertain_point_coords_with_randomness)
    return fn(draw, src_flat, num_points, oversample_ratio, importance_sample_ratio,
              layout=layout)


class _GeneratorDraw:
    """Uniforms and seeds from one ``torch.Generator``, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator, device=self.generator.device)

    def seeds(self, count: int) -> torch.Tensor:
        return torch.randint(0, 1 << 32, (count,), generator=self.generator,
                             device=self.generator.device, dtype=torch.int64)


def device_draw(generator: torch.Generator) -> Draw:
    """The default draw: uniforms and seeds from ``generator`` on its device."""
    return _GeneratorDraw(generator)


def select_matched(pred_masks: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """The matched query's mask per target: (b, q, h, w), (b, t) -> (b, t, h, w)."""
    b = pred_masks.shape[0]
    return pred_masks[torch.arange(b, device=pred_masks.device)[:, None], matched]


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """inputs/targets (n, p) -> (n,) per-mask dice loss."""
    inputs = torch.sigmoid(inputs)
    numerator = 2 * (inputs * targets).sum(-1)
    denominator = inputs.sum(-1) + targets.sum(-1)
    return 1 - (numerator + 1) / (denominator + 1)


def sigmoid_ce_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(n, p) -> (n,) mean binary cross-entropy with logits per mask."""
    return (F.softplus(inputs) - inputs * targets).mean(-1)


def _loss_labels(pred_logits, tgt_labels, tgt_valid, matched, num_classes: int,
                 eos_coef: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy with the no-object class down-weighted: (the weighted
    sum, the sum of the weights, by which it is divided)."""
    b, q, _ = pred_logits.shape
    target_classes = torch.full((b, q), num_classes, dtype=torch.long,
                                device=pred_logits.device)
    scatter_cls = torch.where(tgt_valid, tgt_labels.long(),
                              torch.full_like(tgt_labels.long(), num_classes))
    target_classes.scatter_(1, matched, scatter_cls)
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, target_classes[..., None])[..., 0]
    weight = torch.where(target_classes == num_classes, eos_coef, 1.0)
    return (weight * nll).sum(), weight.sum()


def set_criterion(
    outputs: Dict, targets: Dict, num_classes: int, draw: Draw, *,
    eos_coef: float = 0.1, class_weight: float = 2.0, mask_weight: float = 5.0,
    dice_weight: float = 5.0, num_points: int = 12544, oversample_ratio: float = 3.0,
    importance_sample_ratio: float = 0.75,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
    """The full deep-supervision loss.

    outputs: {'pred_logits', 'pred_masks', 'aux_outputs': tuple of dicts};
    targets: {'labels' (b, t) int, 'masks' (b, t, H, W) float, 'valid' (b, t)
    bool}.  Returns (total weighted loss, unweighted loss terms, the matched
    query per target (b, t) of each layer, main output first)."""
    tgt_labels, tgt_masks, tgt_valid = targets["labels"], targets["masks"], targets["valid"]
    b, t = tgt_labels.shape
    H, W = tgt_masks.shape[-2:]
    all_outputs = [outputs] + list(outputs.get("aux_outputs", ()))
    nl = len(all_outputs)

    # one target sampling for every layer's matcher points, then the cost of
    # each layer and one stacked solve per cost shape
    layer_coords = [draw_rows(draw, b, (num_points, 2), (1, b, 1)) for _ in all_outputs]
    with torch.no_grad():
        tgt_pts = point_sample_shared_batch(
            tgt_masks.reshape(b, t, H * W).transpose(1, 2), H, W, torch.cat(layer_coords, 1))
        costs = [matching_cost(out["pred_logits"], out["pred_masks"], tgt_labels, tgt_masks,
                               tgt_valid, layer_coords[i], class_weight, mask_weight,
                               dice_weight, tgt_pts=tgt_pts[..., i * num_points:
                                                            (i + 1) * num_points])
                 for i, out in enumerate(all_outputs)]
    matched_all = _solve_by_shape(costs, b)

    # the class loss's sums and weights of every layer; the normalisers (the
    # valid targets, each layer's weights) are the global batch's, summed in
    # one reduction
    ce = [_loss_labels(out["pred_logits"], tgt_labels, tgt_valid, matched_all[i], num_classes,
                       eos_coef) for i, out in enumerate(all_outputs)]
    norms = mesh.data_sum_detached(torch.stack([tgt_valid.float().sum()]
                                               + [w.float() for _, w in ce]))
    num_masks = torch.clamp(norms[0], min=1.0)

    # mask losses: every layer of one mask resolution in one sampling pass;
    # the targets, the same for every layer, are sampled once with the layer
    # axis folded into the point axis
    mask_losses = [None] * nl
    groups: Dict[Tuple, list] = {}
    for i, out in enumerate(all_outputs):
        groups.setdefault(tuple(out["pred_masks"].shape[-2:]), []).append(i)
    vf = tgt_valid.reshape(1, b * t).float()
    for shape_hw, idxs in sorted(groups.items()):
        nlg = len(idxs)
        src_flat = torch.cat([select_matched(all_outputs[i]["pred_masks"], matched_all[i])
                              .reshape(b * t, *shape_hw) for i in idxs], 0)
        coords = _uncertain_coords(draw, src_flat.detach(), num_points, oversample_ratio,
                                   importance_sample_ratio, (nlg, b, t))
        ct = (coords.reshape(nlg, b * t, num_points, 2).transpose(0, 1)
              .reshape(b * t, nlg * num_points, 2))
        with torch.no_grad():
            point_labels = point_sample_auto(tgt_masks.reshape(b * t, H, W).float(), ct)
        point_labels = (point_labels.reshape(b * t, nlg, num_points).transpose(0, 1)
                        .reshape(nlg * b * t, num_points))
        point_logits = point_sample_auto(src_flat, coords)
        lm = sigmoid_ce_loss(point_logits, point_labels).reshape(nlg, b * t)
        ld = dice_loss(point_logits, point_labels).reshape(nlg, b * t)
        lm_per = (lm * vf).sum(1) / num_masks
        ld_per = (ld * vf).sum(1) / num_masks
        for k, i in enumerate(idxs):
            mask_losses[i] = (lm_per[k], ld_per[k])

    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for i, out in enumerate(all_outputs):
        l_ce = ce[i][0] / norms[1 + i]
        l_mask, l_dice = mask_losses[i]
        suffix = "" if i == 0 else f"_{i - 1}"
        losses[f"loss_ce{suffix}"] = l_ce
        losses[f"loss_mask{suffix}"] = l_mask
        losses[f"loss_dice{suffix}"] = l_dice
        total = total + class_weight * l_ce + mask_weight * l_mask + dice_weight * l_dice
    return total, losses, matched_all


def _solve_by_shape(costs, b: int) -> list:
    """One stacked solve per cost shape -> each layer's (b, t) matches."""
    matched = [None] * len(costs)
    by_shape: Dict[Tuple, list] = {}
    for i, c in enumerate(costs):
        by_shape.setdefault(tuple(c.shape), []).append(i)
    for idxs in by_shape.values():
        sol = solve_lsap(torch.cat([costs[i] for i in idxs], 0))
        for k, i in enumerate(idxs):
            matched[i] = sol[k * b:(k + 1) * b]
    return matched


def set_criterion_downsample(
    outputs: Dict, targets: Dict, num_classes: int, draw: Draw = None, *,
    eos_coef: float = 0.1, class_weight: float = 2.0, mask_weight: float = 5.0,
    dice_weight: float = 5.0, **_unused,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
    """The downsampled deep-supervision loss: as ``set_criterion`` (its
    arguments; ``draw`` and the point counts are accepted and unused, since
    nothing is drawn), with each layer matched by
    ``matching_cost_downsample`` (one stacked solve per cost shape) and its
    mask losses the sigmoid cross-entropy and dice over all of its pixels
    against the max-pooled targets.  -> (total, unweighted terms, matches)."""
    tgt_labels, tgt_masks, tgt_valid = targets["labels"], targets["masks"], targets["valid"]
    b, t = tgt_labels.shape
    all_outputs = [outputs] + list(outputs.get("aux_outputs", ()))
    costs = [matching_cost_downsample(out["pred_logits"], out["pred_masks"], tgt_labels,
                                      tgt_masks, tgt_valid, class_weight, mask_weight, dice_weight)
             for out in all_outputs]
    matched_all = _solve_by_shape(costs, b)
    ce = [_loss_labels(out["pred_logits"], tgt_labels, tgt_valid, matched_all[i], num_classes,
                       eos_coef) for i, out in enumerate(all_outputs)]
    norms = mesh.data_sum_detached(torch.stack([tgt_valid.float().sum()]
                                               + [w.float() for _, w in ce]))
    num_masks = torch.clamp(norms[0], min=1.0)
    vf = tgt_valid.reshape(b * t).float()
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for i, out in enumerate(all_outputs):
        src = select_matched(out["pred_masks"], matched_all[i])               # (b, t, h, w)
        h, w = src.shape[-2:]
        src_flat = src.reshape(b * t, h * w)
        tgt_flat = max_pool_to(tgt_masks.to(src.dtype), (h, w)).reshape(b * t, h * w)
        suffix = "" if i == 0 else f"_{i - 1}"
        losses[f"loss_ce{suffix}"] = ce[i][0] / norms[1 + i]
        losses[f"loss_mask{suffix}"] = (sigmoid_ce_loss(src_flat, tgt_flat) * vf).sum() / num_masks
        losses[f"loss_dice{suffix}"] = (dice_loss(src_flat, tgt_flat) * vf).sum() / num_masks
        total = (total + class_weight * losses[f"loss_ce{suffix}"]
                 + mask_weight * losses[f"loss_mask{suffix}"]
                 + dice_weight * losses[f"loss_dice{suffix}"])
    return total, losses, matched_all
