"""Space-filling-curve orderings (scanline / Peano / Hilbert) over 2-D
positions.

Counterpart of ``autofocusformermod_tpu/geometry/sfc.py``.  Orders are
defined on a canvas of size (h, w); ``pos`` holds float coordinates (x, y)
in that canvas.  ``calculate_peano_order`` and ``calculate_hilbert_order``
return (order (b, n): the rank of token i on the curve, argsort (b, n): the
index of the token of rank i), both int32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _ranks_from_keys(keys: torch.Tensor):
    """keys: (b, n) -> (order, argsort), ties to the lower index."""
    argsort = torch.argsort(keys, dim=1, stable=True)
    b, n = keys.shape
    order = torch.empty_like(argsort).scatter_(
        1, argsort, torch.arange(n, device=keys.device).expand(b, n))
    return order.int(), argsort.int()


def scanline_order_keys(h: int, w: int) -> np.ndarray:
    """Boustrophedon scanline rank key for every cell of an h x w grid
    (row-major flattened): even rows left-to-right, odd rows right-to-left.
    The row term is multiplied by the full width w, as in the reference."""
    xs = np.arange(w)[None, :].repeat(h, 0)
    ys = np.arange(h)[:, None].repeat(w, 1)
    key = np.where(ys % 2 == 0, 1, -1) * xs + ys * w
    key = key + np.where(ys % 2 == 0, 0, w - 1)
    return key.reshape(-1)


def _levels(pos: torch.Tensor, h: int, base: int, num_levels: int):
    """Each level's cell of every position, coarse to fine: floor(pos / cur_h)
    with the remainder carried on, cur_h shrinking by ``base`` a level."""
    last_h, rem, levels = float(h), pos, []
    for _ in range(num_levels):
        cur_h = last_h / base
        levels.append(torch.floor(rem / cur_h))
        rem = torch.remainder(rem, cur_h)
        last_h = cur_h
    return levels


def _cell(level_pos: torch.Tensor, width: int) -> torch.Tensor:
    return (level_pos[..., 0] + level_pos[..., 1] * width).long()


def calculate_peano_order(h: int, w: int, pos: torch.Tensor):
    """Peano curve order of tokens at ``pos`` (b, n, 2) on an (h, w) canvas."""
    pos = pos.float()
    dev = pos.device
    num_levels = max(1, math.ceil(math.log(h, 3)))
    first_w = None
    if h != w:
        fw = round(3 * (w / h))
        if fw != 3:
            first_w = fw
    init_dict = torch.tensor([[2, 3, 8], [1, 4, 7], [0, 5, 6]], dtype=torch.float32, device=dev)
    inverse_dict = torch.tensor([[[1, 1], [1, -1], [1, 1]],
                                 [[-1, 1], [-1, -1], [-1, 1]],
                                 [[1, 1], [1, -1], [1, 1]]], dtype=torch.float32, device=dev)
    if first_w is not None:
        init_f = torch.cat([init_dict, torch.flip(init_dict, dims=(0,))], dim=1)      # 3 x 6
        init_f = init_f.repeat(1, math.ceil(first_w / 6))[:, :first_w]
        w_index = np.arange(math.ceil(first_w / 3)).repeat(3)[:first_w] * 9
        init_dict_f = (init_f + torch.from_numpy(w_index).float().to(dev)).reshape(-1)
        inverse_dict_f = inverse_dict[:, :2].repeat(1, math.ceil(first_w / 2), 1)[:, :first_w]
        inverse_dict_f = inverse_dict_f.reshape(-1, 2)
    init_flat, inverse_flat = init_dict.reshape(-1), inverse_dict.reshape(-1, 2)
    levels_pos = _levels(pos, h, 3, num_levels)

    orders = []
    for i in range(num_levels):
        inverse = torch.ones_like(pos)
        for j in range(i):
            cur = levels_pos[i - j - 1]
            if i - j - 1 == 0 and first_w is not None:
                cur_inverse = inverse_dict_f[_cell(cur, first_w)]
            else:
                cur_inverse = inverse_flat[_cell(cur, 3)]
            inverse = cur_inverse * inverse
        inversed = torch.where(inverse > 0, levels_pos[i], 2.0 - levels_pos[i])
        if i == 0 and first_w is not None:
            orders.append(init_dict_f[_cell(inversed, first_w)])
        else:
            orders.append(init_flat[_cell(inversed, 3)])
    final = orders[-1]
    for i in range(num_levels - 1):
        final = final + orders[i] * (9 ** (num_levels - i - 1))
    return _ranks_from_keys(final)


def calculate_hilbert_order(h: int, w: int, pos: torch.Tensor):
    """Hilbert curve order of tokens at ``pos`` (b, n, 2) on an (h, w) canvas.
    A canvas more than 1.25 times as wide as high raises: its first level
    has more than 2 columns, and the reference's first-level lookup reads
    past its 4-entry rotation table (where the JAX package's gather fills
    NaN keys)."""
    pos = pos.float()
    dev = pos.device
    b, n, _ = pos.shape
    num_levels = max(1, math.ceil(math.log(h, 2)))
    first_w = None
    if h != w:
        fw = round(2 * (w / h))
        if fw != 2:
            first_w = fw
    if first_w is not None and first_w > 2:
        raise ValueError(f"the Hilbert order of a {h} x {w} canvas reads {2 * first_w} "
                         "first-level cells from a 4-entry table")
    rotate_dict = torch.tensor([[[-1, 1], [0, 0]], [[0, -1], [0, 1]], [[1, 0], [-1, 0]]],
                               dtype=torch.float32, device=dev)                  # 3 x 2 x 2
    if first_w is not None:
        rotate_dict_f = rotate_dict[0].repeat(1, math.ceil(first_w / 2))[:, :first_w].reshape(-1)
    rotate_flat = rotate_dict.reshape(3, -1)                                     # 3 x 4
    rot_res_dict = torch.tensor([[0, 3, 1, 2], [2, 3, 1, 0], [2, 1, 3, 0], [0, 1, 3, 2]],
                                dtype=torch.float32, device=dev)                 # 4 x 4
    levels_pos = _levels(pos, h, 2, num_levels)

    orders = []
    for i in range(num_levels):
        level_index = _cell(levels_pos[i], first_w if i == 0 and first_w is not None else 2)
        rotate = torch.zeros((b, n), dtype=torch.float32, device=dev)
        for j in range(i):
            cur = levels_pos[j]
            if j == 0 and first_w is not None:
                cur_rotate = rotate_dict_f[_cell(cur, first_w)]
            else:
                rotate_d = rotate_flat[torch.remainder(rotate, 3).long()]         # (b, n, 4)
                cur_rotate = torch.gather(rotate_d, 2, _cell(cur, 2)[..., None])[..., 0]
            rotate = cur_rotate + rotate
        rotate = torch.remainder(rotate, 4)
        rotate_res = rot_res_dict[rotate.long()]                                  # (b, n, 4)
        orders.append(torch.gather(rotate_res, 2, level_index[..., None])[..., 0])
    final = orders[-1]
    for i in range(num_levels - 1):
        final = final + orders[i] * (4 ** (num_levels - i - 1))
    return _ranks_from_keys(final)
