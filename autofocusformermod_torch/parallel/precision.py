"""bf16 mixed precision (SOLVER.AMP.ENABLED): fp32 master parameters, bf16
compute.

Counterpart of ``autofocusformermod_tpu/parallel/precision.py``.  As there,
the policy is a dtype policy and not an autocast context: for one forward
the float parameters are cast to bf16 (``amp_parameters``, differentiable
``.to`` casts, so gradients arrive fp32 on the masters) and the model is
called on that view (``apply``: ``torch.func.functional_call``).  Every
layer then computes in bf16, norms and softmaxes included, except the
parameters whose names hold ``KEEP_F32`` or an active fp32 island's paths.
Master parameters, AdamW state and BatchNorm running statistics stay fp32
(a module casts its statistics to the activations' dtype where it reads
them); geometry (positions, clustering, knn, Shepard distances) is fp32 by
construction; the kernels take fp32 operands, cast up at their call and
back down after, as the JAX modules do; and a meta-architecture returns
fp32 outputs (``f32_outputs``) to the criterion, the matcher and inference.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

# parameter-name substrings kept fp32 under the policy: the deformable
# sampling offsets are geometry, and rounding them to bf16 moves sampled
# points and flips nearest-cell snaps
KEEP_F32 = ("sampling_offsets",)

# fp32 islands: name -> parameter-name substrings that stay fp32 (the JAX
# package's ISLAND_PARAM_PATHS under the port's names, the reference's
# state-dict names).  The matching activation casts are in
# models/maskformer.py (MaskFormer, MaskFormerHead) and
# models/transformer_decoder.py (the mask head).
ISLAND_PARAM_PATHS = {
    "backbone": ("backbone.",),
    "pixel_decoder": ("pixel_decoder.",),
    "decoder": ("predictor.",),
    "mask_head": ("predictor.decoder_norm", "predictor.class_embed", "predictor.mask_embed"),
}

# no island by default (uniform bf16), as the JAX package
DEFAULT_F32_ISLANDS = ""


def active_f32_islands() -> Tuple[str, ...]:
    """The fp32 islands under AMP: the comma list in AFF_F32_ISLANDS ('' =
    none), else ``DEFAULT_F32_ISLANDS``.  An unknown name raises."""
    env = os.environ.get("AFF_F32_ISLANDS")
    if env is None:
        env = DEFAULT_F32_ISLANDS
    names = tuple(s.strip() for s in env.split(",") if s.strip())
    for n in names:
        if n not in ISLAND_PARAM_PATHS:
            raise ValueError(f"unknown fp32 island {n!r}; known: {sorted(ISLAND_PARAM_PATHS)}")
    return names


def island_keep_paths(islands: Optional[Tuple[str, ...]] = None) -> Tuple[str, ...]:
    """The parameter-name substrings that the islands keep fp32."""
    if islands is None:
        islands = active_f32_islands()
    paths: Tuple[str, ...] = ()
    for n in islands:
        paths += ISLAND_PARAM_PATHS[n]
    return paths


def compute_dtype(cfg) -> torch.dtype:
    """bf16 where the config turns SOLVER.AMP.ENABLED on, else fp32 (also for
    a preset without the field)."""
    amp = getattr(getattr(cfg.SOLVER, "AMP", None), "ENABLED", False)
    return torch.bfloat16 if amp else torch.float32


def amp_islands(cfg) -> Tuple[str, ...]:
    """The fp32 islands of a model built from ``cfg``: the active ones under
    AMP, none without."""
    return active_f32_islands() if compute_dtype(cfg) == torch.bfloat16 else ()


def refuse_islands(cfg, arch: str) -> None:
    """Raise where a meta-architecture whose modules make no island casts
    (every one but MaskFormer) is built under AMP with an fp32 island
    active: the JAX package keeps the island's parameters fp32 there and
    flax promotes each layer that meets them, which the port's layers do
    not do."""
    islands = amp_islands(cfg)
    if islands:
        raise NotImplementedError(
            f"fp32 islands {islands} (AFF_F32_ISLANDS) under AMP are ported for MaskFormer, "
            f"not {arch}")


def cast_floating(named: Dict[str, torch.Tensor], dtype: torch.dtype = torch.bfloat16,
                  keep_f32: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """{name: tensor} with every fp32 tensor cast to ``dtype`` (other dtypes
    pass), except those whose name holds a ``keep_f32`` substring."""
    def cast(name, t):
        if t.dtype != torch.float32 or any(k in name for k in keep_f32):
            return t
        return t.to(dtype)

    return {name: cast(name, t) for name, t in named.items()}


def f32_outputs(tree: Any) -> Any:
    """bf16 and fp16 tensors of a nested dict / tuple / list cast to fp32."""
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.dtype in (torch.bfloat16, torch.float16) else tree
    if isinstance(tree, dict):
        return {k: f32_outputs(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(f32_outputs(v) for v in tree)
    return tree


def uses_amp(model: nn.Module) -> bool:
    """Whether the model computes in bf16 (its build function read SOLVER.AMP.ENABLED)."""
    return getattr(model, "compute_dtype", torch.float32) == torch.bfloat16


def amp_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The bf16 view of the model's parameters for one forward: KEEP_F32 and
    the model's fp32 islands (``model.f32_islands``) stay the fp32 masters."""
    keep = KEEP_F32 + island_keep_paths(getattr(model, "f32_islands", ()))
    return cast_floating(dict(model.named_parameters()), keep_f32=keep)


def apply(model: nn.Module, *args, **kwargs):
    """``model(*args, **kwargs)``; for a model that computes in bf16, on the
    bf16 view of its parameters (``amp_parameters``)."""
    if not uses_amp(model):
        return model(*args, **kwargs)
    return torch.func.functional_call(model, amp_parameters(model), args, kwargs)
