"""Morton (Z-order) ranks for power-of-two grids.

Counterpart of ``autofocusformermod_tpu/geometry/morton.py``.  The pixel
decoder's channel-major sampling prep reorders its finest-grid neighbour
tables by Morton rank, so that cells near each other in space lie near each
other in the table, and looks rows up by rank
(``ops/window_gather.py:windowed_row_gather``).

Rectangular grids interleave the low min(log2(W), log2(H)) bits of x and y
and carry the longer side's high bits above them: dense ranks in [0, W*H)
for any power-of-two W, H.
"""

from __future__ import annotations

import functools

import numpy as np


def _spread_bits(v):
    """Insert a zero between consecutive bits (values below 2^16).  Shifts and
    masks only: works on numpy arrays and on int32/int64 tensors alike."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_rank(gx, gy, log2_w: int, log2_h: int):
    """Dense Morton rank of integer cell coordinates on a (2^log2_h, 2^log2_w)
    grid.  gx/gy: int32 tensors (or numpy integer arrays) -> same shape and type."""
    m = min(log2_w, log2_h)
    mask = (1 << m) - 1
    rank = (_spread_bits(gx & mask) << 1) | _spread_bits(gy & mask)
    if log2_w > log2_h:
        rank = rank | ((gx >> m) << (2 * m))
    elif log2_h > log2_w:
        rank = rank | ((gy >> m) << (2 * m))
    return rank


@functools.lru_cache(maxsize=None)
def morton_perm(h: int, w: int) -> np.ndarray:
    """perm[rank] = raster cell id (gy * w + gx), so ``table[perm]`` lists the
    rows in Morton order.  h, w: powers of two.  Cached: treat as read-only."""
    if not (is_pow2(h) and is_pow2(w)):
        raise ValueError(f"morton_perm needs power-of-two sides, got {h} x {w}")
    log2_w, log2_h = int(w).bit_length() - 1, int(h).bit_length() - 1
    ys, xs = np.meshgrid(np.arange(h, dtype=np.int64), np.arange(w, dtype=np.int64),
                         indexing="ij")
    rank = morton_rank(xs.reshape(-1), ys.reshape(-1), log2_w, log2_h)
    perm = np.empty(h * w, dtype=np.int64)
    perm[rank] = np.arange(h * w, dtype=np.int64)
    return perm


def is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0
