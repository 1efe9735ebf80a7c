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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from .matcher import matching_cost, solve_lsap
from .point_sample import (Draw, get_uncertain_point_coords_nn_ranked,
                           get_uncertain_point_coords_with_randomness, point_sample_auto,
                           point_sample_shared_batch)

# Rank the oversampled candidates with a one-tap nearest-cell read instead of
# the four-tap bilinear one (a selection heuristic only: the supervision stays
# at continuous points).  Off, the reference's exact sampler runs.
NN_RANK_UNCERTAINTY = True


def _uncertain_coords(draw, src_flat, num_points, oversample_ratio, importance_sample_ratio):
    fn = (get_uncertain_point_coords_nn_ranked if NN_RANK_UNCERTAINTY
          else get_uncertain_point_coords_with_randomness)
    return fn(draw, src_flat, num_points, oversample_ratio, importance_sample_ratio)


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
                 eos_coef: float) -> torch.Tensor:
    """Cross-entropy with the no-object class down-weighted."""
    b, q, _ = pred_logits.shape
    target_classes = torch.full((b, q), num_classes, dtype=torch.long,
                                device=pred_logits.device)
    scatter_cls = torch.where(tgt_valid, tgt_labels.long(),
                              torch.full_like(tgt_labels.long(), num_classes))
    target_classes.scatter_(1, matched, scatter_cls)
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, target_classes[..., None])[..., 0]
    weight = torch.where(target_classes == num_classes, eos_coef, 1.0)
    return (weight * nll).sum() / weight.sum()


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
    num_masks = torch.clamp(tgt_valid.float().sum(), min=1.0)
    all_outputs = [outputs] + list(outputs.get("aux_outputs", ()))
    nl = len(all_outputs)

    # one target sampling for every layer's matcher points, then the cost of
    # each layer and one stacked solve per cost shape
    layer_coords = [draw((b, num_points, 2)) for _ in all_outputs]
    with torch.no_grad():
        tgt_pts = point_sample_shared_batch(
            tgt_masks.reshape(b, t, H * W).transpose(1, 2), H, W, torch.cat(layer_coords, 1))
        costs = [matching_cost(out["pred_logits"], out["pred_masks"], tgt_labels, tgt_masks,
                               tgt_valid, layer_coords[i], class_weight, mask_weight,
                               dice_weight, tgt_pts=tgt_pts[..., i * num_points:
                                                            (i + 1) * num_points])
                 for i, out in enumerate(all_outputs)]
    matched_all = [None] * nl
    by_shape: Dict[Tuple, list] = {}
    for i, c in enumerate(costs):
        by_shape.setdefault(tuple(c.shape), []).append(i)
    for idxs in by_shape.values():
        sol = solve_lsap(torch.cat([costs[i] for i in idxs], 0))
        for k, i in enumerate(idxs):
            matched_all[i] = sol[k * b:(k + 1) * b]

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
                                   importance_sample_ratio)
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
        l_ce = _loss_labels(out["pred_logits"], tgt_labels, tgt_valid, matched_all[i],
                            num_classes, eos_coef)
        l_mask, l_dice = mask_losses[i]
        suffix = "" if i == 0 else f"_{i - 1}"
        losses[f"loss_ce{suffix}"] = l_ce
        losses[f"loss_mask{suffix}"] = l_mask
        losses[f"loss_dice{suffix}"] = l_dice
        total = total + class_weight * l_ce + mask_weight * l_mask + dice_weight * l_dice
    return total, losses, matched_all
