"""Balanced clustering of token point clouds along a space-filling curve.

Counterpart of ``autofocusformermod_tpu/geometry/cluster.py``: the scanline
curve (``sf_type=''``, what every model uses), the Peano curve and the
Hilbert curve.  Tokens are sorted along the curve over anchor patches and
the sorted sequence is cut into clusters of exactly ``m`` tokens.
Everything here is index bookkeeping with no gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..parallel import mesh
from .sfc import calculate_hilbert_order, calculate_peano_order, scanline_order_keys

CURVES = {"peano": calculate_peano_order, "hilbert": calculate_hilbert_order}


def _anchor_grid(h: int, w: int, k: int, sf_type: str = ""):
    """Anchor-patch layout: grid size and patch extents (a power of 3 or 2
    of rows for the Peano and Hilbert curves)."""
    patch_len = (h * w / k) ** 0.5
    num_patch_h = max(1, int(round(h / patch_len)))
    num_patch_w = max(1, int(round(w / patch_len)))
    patch_len_h, patch_len_w = h / num_patch_h, w / num_patch_w
    if sf_type in CURVES:
        base = 3 if sf_type == "peano" else 2
        num_patch_h = max(base, int(base ** round(math.log(num_patch_h, base))))
        patch_len_h = h / num_patch_h
        num_patch_w = int(round(w / h * base) * (num_patch_h / base))
        patch_len_w = w / num_patch_w
    return num_patch_h, num_patch_w, patch_len_h, patch_len_w


def _grid_curve_order(num_patch_h: int, num_patch_w: int, w: int, sf_type: str = ""):
    """The anchor cells' order on the curve: (order_grid_idx, order_idx, grid_pos)."""
    xs = np.arange(num_patch_w)[None, :].repeat(num_patch_h, 0)
    ys = np.arange(num_patch_h)[:, None].repeat(num_patch_w, 1)
    grid_pos = np.stack([xs, ys], axis=2).reshape(-1, 2).astype(np.float32)
    if sf_type in CURVES:
        order_grid_idx, order_idx = CURVES[sf_type](num_patch_h, num_patch_w,
                                                    torch.from_numpy(grid_pos)[None])
        return order_grid_idx[0].long().numpy(), order_idx[0].long().numpy(), grid_pos
    order_mask = np.where(ys % 2 == 0, 1, -1) * xs + ys * w
    order_mask = (order_mask + np.where(ys % 2 == 0, 0, w - 1)).reshape(-1)
    order_idx = np.argsort(order_mask, kind="stable")
    order_grid_idx = np.zeros_like(order_idx)
    order_grid_idx[order_idx] = np.arange(len(order_idx))
    return order_grid_idx, order_idx, grid_pos


def space_filling_cluster(pos: torch.Tensor, m: int, h: int, w: int, sf_type: str = ""):
    """Cluster (b, n, 2) positions on an (h, w) canvas into ceil(n/m) clusters
    along the curve ``sf_type`` ('', scanline; 'peano'; 'hilbert').

    Returns (pos_sorted (b, n, 2), cluster_mean_pos (b, k, 2), member_idx
    (b, k, m) int32 indices into the sorted tokens, cluster_mask (b, k, m)
    int32 or None when k*m == n, pos_ranking (b, n, 1) int32: index of the
    token of rank i)."""
    pos = pos.detach().float()
    dev = pos.device
    b, n, d = pos.shape
    k = int(math.ceil(n / m))
    nph, npw, plh, plw = _anchor_grid(h, w, k, sf_type)

    if nph * npw >= 3:
        order_grid_idx, order_idx, grid_pos = _grid_curve_order(nph, npw, w, sf_type)
        ordered_grid = grid_pos[order_idx]
        patch_len_hw = np.array([plw, plh], dtype=np.float32)
        init_pos_means = ordered_grid * patch_len_hw + patch_len_hw / 2 - 0.5
        nump = ordered_grid.shape[0]
        prev_means = np.zeros_like(init_pos_means)
        prev_means[1:] = init_pos_means[: nump - 1]
        prev_means[0] = prev_means[1] - (prev_means[2] - prev_means[1])
        next_means = np.zeros_like(init_pos_means)
        next_means[: nump - 1] = init_pos_means[1:]
        next_means[-1] = next_means[-2] + (next_means[-2] - next_means[-3])

        cell = torch.floor(pos / torch.from_numpy(patch_len_hw).to(dev))
        cell = (cell[..., 0] + cell[..., 1] * npw).long()
        rank = torch.from_numpy(order_grid_idx).to(dev)[cell]           # (b, n)
        prev_assign = torch.from_numpy(prev_means).to(dev)[rank]
        next_assign = torch.from_numpy(next_means).to(dev)[rank]
        dist_prev = ((pos - prev_assign) ** 2).sum(-1)
        dist_next = ((pos - next_assign) ** 2).sum(-1)
        dist_ratio = dist_prev / (dist_next + 1e-5)
        # the whole batch's largest ratio (the global batch's in a
        # data-parallel step), as the reference
        key = rank.float() * (mesh.data_max_detached(dist_ratio.max()) + 1) + dist_ratio
        pos_ranking = torch.argsort(key, dim=1, stable=True)
    elif sf_type in CURVES:
        # too few anchors for the prev/next refinement: order tokens on the
        # curve directly
        pos_ranking = CURVES[sf_type](h, w, pos)[1].long()
    else:
        order = torch.from_numpy(scanline_order_keys(h, w)).to(dev)
        keys = order[(pos[..., 0] + pos[..., 1] * w).long()]
        pos_ranking = torch.argsort(keys, dim=1, stable=True)

    pos_sorted = torch.gather(pos, 1, pos_ranking[..., None].expand(b, n, d))
    if k * m == n:
        cluster_mask = None
        cluster_mean_pos = pos_sorted.reshape(b, k, m, d).mean(dim=2)
    else:
        pad = k * m - n
        pos_pad = torch.nn.functional.pad(pos_sorted, (0, 0, 0, pad))
        cluster_mask = torch.nn.functional.pad(
            torch.ones((b, n), dtype=torch.int32, device=dev), (0, pad)).reshape(b, k, m)
        cluster_mean_pos = pos_pad.reshape(b, k, m, d).sum(dim=2) / cluster_mask.sum(
            dim=2, keepdim=True).float()
    member_idx = torch.arange(k * m, dtype=torch.int32, device=dev)
    member_idx[n:] = 0
    member_idx = member_idx.expand(b, k * m).reshape(b, k, m)
    return pos_sorted, cluster_mean_pos, member_idx, cluster_mask, pos_ranking[..., None].int()


def nbhd_from_cluster_ids(pos: torch.Tensor, nc: torch.Tensor, span: int, n: int,
                          query_pos: Optional[torch.Tensor] = None):
    """Fixed-width neighbourhoods from neighbour-cluster ids: cluster c holds
    rows [c*span, (c+1)*span); entries >= n are padding (mask 0).

    pos: (b, n, 2); nc: (b, nq, nnc); query_pos: neighbourhood centres
    (default: the first nq rows of pos).  Returns (member_idx (b, nq,
    nnc*span) int32, cluster_mask (b, nq, nnc*span) f32 or None, rel_feat5
    (b, nq, nnc*span, 5))."""
    from ..models.layers import rel_pos_features
    from ..ops.gather import take_rows

    b, nq, nnc = nc.shape
    member = (nc[..., None].int() * span
              + torch.arange(span, dtype=torch.int32, device=nc.device)).reshape(b, nq, nnc * span)
    valid = member < n
    member = torch.where(valid, member, torch.zeros_like(member))
    cluster_mask = None if n % span == 0 else valid.float()
    pos_nb = take_rows(pos, member)
    q = pos[:, :nq] if query_pos is None else query_pos
    return member, cluster_mask, rel_pos_features(pos_nb - q[:, :, None, :])
