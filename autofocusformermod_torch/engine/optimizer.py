"""Optimizer, LR schedule and full-model gradient clipping.

Counterpart of ``autofocusformermod_tpu/engine/optimizer.py``
(``build_optimizer``): AdamW over six parameter groups -- backbone or not,
times default / norm (weight decay WEIGHT_DECAY_NORM) / embed (weight decay
WEIGHT_DECAY_EMBED) -- with the backbone's learning rate times
BACKBONE_MULTIPLIER, detectron2's WarmupPolyLR, and optax's
``clip_by_global_norm`` applied to the whole model before the update.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from ..models.resnet import FrozenBN

_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d, FrozenBN)
# parameters that make_label_fn puts in the norm group by their own name
_NORM_TABLES = ("relative_position_bias_table", "absolute_pos_embed")


def param_label(mod_name: str, leaf: str, mod: nn.Module) -> str:
    """A parameter's group, as the JAX package's ``make_label_fn`` labels
    its flax leaf: ``embed`` for embedding tables, ``norm`` for the
    parameters of a norm (every flax module the JAX rule names as a norm is
    one of ``_NORMS`` here, the R50's FrozenBN too) and for the
    relative-position and absolute position tables, else ``default``;
    prefixed ``backbone_`` where a component of the name contains
    "backbone"."""
    name = f"{mod_name}.{leaf}" if mod_name else leaf
    if isinstance(mod, nn.Embedding):
        kind = "embed"
    elif isinstance(mod, _NORMS) or leaf in _NORM_TABLES:
        kind = "norm"
    else:
        kind = "default"
    return ("backbone_" + kind) if any("backbone" in p for p in name.split(".")) else kind


def param_groups(model: nn.Module) -> Dict[str, List[Tuple[str, nn.Parameter]]]:
    """{label: [(name, parameter)]} with the JAX package's labels
    (``param_label``)."""
    groups: Dict[str, List[Tuple[str, nn.Parameter]]] = {}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            groups.setdefault(param_label(mod_name, leaf, mod), []).append((name, p))
    return groups


def warmup_poly_factor(step: int, max_iter: int, warmup_factor: float, warmup_iters: int,
                       power: float, constant_ending: float) -> float:
    """detectron2 WarmupPolyLR's multiplier of the base learning rate."""
    warm = 1.0
    if step < warmup_iters:
        frac = step / max(warmup_iters, 1)
        warm = warmup_factor * (1 - frac) + frac
    return warm * max((1.0 - step / max_iter) ** power, constant_ending)


def build_optimizer(cfg, model: nn.Module):
    """-> (torch.optim.AdamW, LambdaLR scheduler) from cfg.SOLVER.  Step the
    scheduler after every optimizer step (optax counts updates the same way)."""
    s = cfg.SOLVER
    decay = {"default": s.WEIGHT_DECAY, "norm": s.WEIGHT_DECAY_NORM,
             "embed": s.WEIGHT_DECAY_EMBED}
    groups = []
    for label, named in param_groups(model).items():
        kind = label.replace("backbone_", "")
        mult = s.BACKBONE_MULTIPLIER if label.startswith("backbone_") else 1.0
        groups.append({"params": [p for _, p in named], "lr": s.BASE_LR * mult,
                       "weight_decay": decay[kind], "label": label})
    opt = torch.optim.AdamW(groups, lr=s.BASE_LR, betas=tuple(s.BETAS), eps=s.EPSILON)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: warmup_poly_factor(
        step, s.MAX_ITER, s.WARMUP_FACTOR, s.WARMUP_ITERS, s.POLY_LR_POWER,
        s.POLY_LR_CONSTANT_ENDING))
    return opt, sched


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.sqrt(sum((g ** 2).sum() for g in grads))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm reaches
    max_norm every gradient becomes g / norm * max_norm (no epsilon, unlike
    torch's clip_grad_norm_).  ``norm``: the global norm where the caller
    has it (of sharded gradients), else ``global_norm(grads)``.  Returns the
    norm before clipping."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
