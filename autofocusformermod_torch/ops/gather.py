"""Flat row gathers: the row-lookup primitive every neighbourhood op uses.

The batch is folded into the row index and one ``index_select`` runs over a
``(b * n, c)`` view.  Indices must lie in ``[0, n)``.  Also the top-k with
JAX's tie rule, which the token selection and the point ranking share.
"""

from __future__ import annotations

import torch


def _flat_index(idx: torch.Tensor, b: int, n: int) -> torch.Tensor:
    boff = torch.arange(b, device=idx.device, dtype=torch.long) * n
    boff = boff.reshape((b,) + (1,) * (idx.dim() - 1))
    return (idx.long() + boff).reshape(-1)


def take_rows(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat: (b, n, c); idx: (b, ...) int -> (b, ..., c)."""
    b, n, c = feat.shape
    out = feat.reshape(b * n, c).index_select(0, _flat_index(idx, b, n))
    return out.reshape(*idx.shape, c)


def take_scalars(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (b, n); idx: (b, ...) int -> (b, ...)."""
    b, n = x.shape
    return x.reshape(b * n).index_select(0, _flat_index(idx, b, n)).reshape(idx.shape)


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of x (rows, n), in
    descending order with ties to the lowest index (jax.lax.top_k's order;
    torch.topk promises neither): a full stable sort."""
    return torch.sort(x, dim=1, descending=True, stable=True)[1][:, :k]
