"""dtype promotion as JAX and flax compute it, for the mixed-precision path.

A flax layer computes in the common dtype of its input and its parameters
(``promote_dtype``), and a JAX einsum in that of its operands: fp32 that
meets bf16 computes in fp32, with the bf16 values widened exactly.  PyTorch
promotes elementwise ops the same way, but its linear, matmul, einsum,
convolution and norm functions refuse mixed operands.  ``promoted`` widens
the operands of one such call; ``flax_promotion`` does it for every such
call made inside it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode


def _common(dtypes) -> torch.dtype:
    dts = iter(dtypes)
    dt = next(dts)
    for d in dts:
        dt = torch.promote_types(dt, d)
    return dt


def promoted(*tensors: torch.Tensor):
    """The tensors in their common dtype, as JAX promotes the operands of an
    einsum or a flax layer (None passes)."""
    dt = _common(t.dtype for t in tensors if t is not None)
    return [t if t is None else t.to(dt) for t in tensors]


# the calls that take a layer's parameters or an einsum's operands and
# refuse mixed float dtypes
_PROMOTING = frozenset((
    F.linear, F.bilinear, F.layer_norm, F.group_norm, F.conv1d, F.conv2d, F.conv_transpose2d,
    F.multi_head_attention_forward, F.scaled_dot_product_attention,
    torch.einsum, torch.matmul, torch.bmm, torch.baddbmm, torch.addmm,
    torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.Tensor.bmm,
))


def _floats(tree: Any):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _floats(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _floats(t)


def _cast(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree


class _FlaxPromotion(TorchFunctionMode):
    def __torch_function__(self, func, types, args: Tuple = (), kwargs=None):
        kwargs = kwargs or {}
        if func in _PROMOTING:
            dtypes = {t.dtype for t in _floats((args, kwargs))}
            if len(dtypes) > 1:
                dt = _common(dtypes)
                args, kwargs = _cast(args, dt), _cast(kwargs, dt)
        return func(*args, **kwargs)


def flax_promotion() -> TorchFunctionMode:
    """A context in which every linear, norm, convolution, attention, matmul
    and einsum call computes in its float operands' common dtype, as flax
    and JAX do: for a model whose fp32 activations meet the bf16 view of its
    parameters (the MaskFiner cascades' projection decoders cast their
    levels to fp32)."""
    return _FlaxPromotion()
