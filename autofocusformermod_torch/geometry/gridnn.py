"""Exact nearest-neighbour lookups against a token set that covers a full grid.

Counterpart of ``autofocusformermod_tpu/geometry/gridnn.py``: the k nearest
grid nodes of a query lie in a small window around it, so no distance
matrix is built.  Token indices come through a cell -> token lookup table.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.clusten import weighted_gather
from ..ops.gather import take_scalars
from .shepard import shepard_decay_weights

_FAR = 1e10


def pos_index_lut(pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """pos: (b, n, 2), a permutation of the h x w grid -> (b, h*w) int64 LUT
    from row-major cell id to token index."""
    b, n, _ = pos.shape
    if n != h * w:
        raise ValueError(f"token set does not cover the grid: {n} != {h}*{w}")
    cell = pos[..., 1].long() * w + pos[..., 0].long()
    lut = torch.zeros((b, h * w), dtype=torch.long, device=pos.device)
    return lut.scatter_(1, cell, torch.arange(n, device=pos.device).expand(b, n))


def lex_sort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Permutation along the last axis sorting by (primary, secondary)
    lexicographically: a stable sort by the secondary key, then by the primary."""
    o2 = torch.argsort(secondary, dim=-1, stable=True)
    o1 = torch.argsort(torch.gather(primary, -1, o2), dim=-1, stable=True)
    return torch.gather(o2, -1, o1)


def _window_knn(query: torch.Tensor, h: int, w: int, half: int, k: int,
                lut: Optional[torch.Tensor] = None, identity_lut: bool = False):
    """Exact k-NN among the tokens of a full grid from a (2*half+2)^2 window
    anchored at floor(query).  ``lut`` maps cell -> token; ``identity_lut``
    declares token == cell (raster order).  Returns (token_idx, d2), ties by
    the lowest token index, as a brute-force knn over the token set."""
    x, y = query[..., 0], query[..., 1]
    fx = torch.floor(torch.clamp(x, 0, w - 1))
    fy = torch.floor(torch.clamp(y, 0, h - 1))
    offs = torch.arange(-half, half + 2, dtype=torch.float32, device=query.device)
    gx = (fx[..., None] + offs)[..., :, None]                       # (b, nq, win, 1)
    gy = (fy[..., None] + offs)[..., None, :]                       # (b, nq, 1, win)
    d2 = (gx - x[..., None, None]) ** 2 + (gy - y[..., None, None]) ** 2
    oob = (gx < 0) | (gx > w - 1) | (gy < 0) | (gy > h - 1)
    d2 = torch.where(oob, torch.full_like(d2, _FAR), d2)
    win = offs.shape[0]
    d2 = d2.reshape(*x.shape, win * win)
    cells = (torch.clamp(gy, 0, h - 1) * w + torch.clamp(gx, 0, w - 1)).long()
    cells = cells.expand(*x.shape, win, win).reshape(*x.shape, win * win)
    if identity_lut:
        tok = cells
    else:
        b = lut.shape[0]
        tok = take_scalars(lut, cells.reshape(b, -1)).reshape(cells.shape)
    order = lex_sort(d2, tok)[..., :k]
    return torch.gather(tok, -1, order), torch.gather(d2, -1, order)


def grid_shepard_neighbours(query: torch.Tensor, h: int, w: int, power=3.0):
    """The 4 nearest cells of the raster-ordered h x w grid (token == cell)
    to each query (b, n, 2) and their Shepard weights -> (nn_idx (b, n, 4),
    weights (b, n, 4)), for ``weighted_gather``; several features
    interpolated at the same queries share them."""
    nn_idx, d2 = _window_knn(query, h, w, 1, 4, identity_lut=True)
    return nn_idx, shepard_decay_weights(d2, power=power)


def grid_shepard_upsample(query: torch.Tensor, feature: torch.Tensor, h: int, w: int,
                          power=3.0) -> torch.Tensor:
    """Shepard interpolation (k=4) of ``feature`` given on the raster-ordered
    h x w grid (token == cell) at ``query``; the same result as
    upsample_feature_shepard against the grid positions."""
    return weighted_gather(*grid_shepard_neighbours(query, h, w, power), feature)


def grid_neighbors9(pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Each token's exact 9 nearest tokens of a full-grid token set -> (b, n, 9)."""
    nn_idx, _ = _window_knn(pos.float(), h, w, 2, 9, lut=pos_index_lut(pos, h, w))
    return nn_idx
