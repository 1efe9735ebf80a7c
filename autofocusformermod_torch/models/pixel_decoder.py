"""Point-cloud multi-scale deformable-attention pixel decoder.

Counterpart of ``autofocusformermod_tpu/models/pixel_decoder.py`` (its XLA
path): per-level Linear+LN input projections, encoder layers whose
MSDeformAttnPc samples each head/level/point location through a packed 4-NN
table on the finest grid with Shepard weights, aggregated by the
``msdetrpc`` kernels on CUDA; then the FPN level by Shepard upsampling and a
dense-grid PointConv.

The sampling operands can be built in four layouts, chosen by the module
constants below (same names and defaults as the JAX module's); each reaches
its own kernel:

- default (``USE_STACKED_GLUE``): the levels stacked on the pair axis ->
  ``ops/msdetrpc.py:msdetrpc_levels_s``, for every level size;
- ``USE_STACKED_GLUE`` off: one operand per level -> ``msdetrpc_levels`` when
  every level size is a multiple of 128 (the JAX gate), else the interleaved
  operands -> ``ops/clusten.py:msdetrpc``;
- ``USE_FUSED_PREP``: for fine query levels the whole prep runs channel-major
  (queries minor), the packed rows come from Morton-ordered channel-major
  tables through ``ops/window_gather.py:windowed_row_gather`` ->
  ``msdetrpc_levels_t``;
- ``USE_BH_LAYOUT``: heads stay where the Linear put them -> ``msdetrpc_bh``.

Under mixed precision the sampling offsets stay fp32 (KEEP_F32: their
Linear promotes the bf16 queries), the sampling weights are fp32 geometry,
the kernels take fp32 values and their result is cast back to the compute
dtype; the sine embeddings, the Shepard-upsampled levels and the PointConv
weights are cast down to it, as in the JAX module.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..geometry.gridnn import grid_neighbors9, lex_sort, pos_index_lut
from ..geometry.knn import knn
from ..geometry.morton import is_pow2, morton_perm, morton_rank
from ..geometry.shepard import shepard_decay_weights, upsample_feature_shepard
from ..ops.clusten import cluster_wf, msdetrpc
from ..ops.gather import take_rows, take_scalars
from ..ops.msdetrpc import msdetrpc_bh, msdetrpc_levels, msdetrpc_levels_s, msdetrpc_levels_t
from ..ops.window_gather import windowed_row_gather
from ..dtypes import promoted
from .layers import (Dropout, WeightNet, dense, layer_norm, position_embedding_sine,
                     rel_pos_features)

# The layout of the sampling operands (module docstring).  Read at call time:
# set them on this module to choose a layout.
USE_STACKED_GLUE = os.environ.get("MSDETRPC_STACKED", "1").strip().lower() not in (
    "0", "false", "no")
USE_FUSED_PREP = False
USE_BH_LAYOUT = False


def _levels_ok(level_sizes, ntot: int) -> bool:
    """Gate of the per-level, channel-major and head-natural routes (the JAX
    module's): the levels partition the value table in multiples of 128."""
    return sum(level_sizes) == ntot and all(nj % 128 == 0 for nj in level_sizes)


def _msdetrpc_dispatch(idxs_local, ws_shepard, attn_perm, values_all, level_sizes):
    """The sampling contraction with ``USE_STACKED_GLUE`` off.

    idxs_local: per level j (bh, n_i, k, 4) int32 LOCAL indices into level j's
    value rows; ws_shepard: matching Shepard weights; attn_perm: (bh, n_i, l, k)
    softmaxed attention; values_all: (bh, ntot, c_) -> (bh, n_i, c_).  Level
    sizes all multiples of 128: one operand per level, the attention folded
    into the weights.  Else the interleaved operands (slot = point * l +
    level, global indices), the attention multiplied in the kernel.  The
    kernels take fp32 operands; the result comes back in values_all's dtype."""
    bh, n_i, kpts, kk = idxs_local[0].shape
    n_levels = len(level_sizes)
    dt = values_all.dtype
    if _levels_ok(level_sizes, values_all.shape[1]):
        idxs = [i.reshape(bh, n_i, kpts * kk) for i in idxs_local]
        ws = [(w.float() * attn_perm[:, :, j, :, None].float()).reshape(bh, n_i, kpts * kk)
              for j, w in enumerate(ws_shepard)]
        return msdetrpc_levels(idxs, ws, values_all.float(), level_sizes).to(dt)
    offs = np.cumsum([0] + list(level_sizes))[:-1]
    nn_idxs = torch.stack([i + int(o) for i, o in zip(idxs_local, offs)], dim=3)
    nn_weights = torch.stack(ws_shepard, dim=3)
    attn_i = attn_perm.permute(0, 1, 3, 2).reshape(bh, n_i, kpts * n_levels)
    return msdetrpc(nn_idxs.reshape(bh, n_i, kpts * n_levels, kk),
                    nn_weights.float().reshape(bh, n_i, kpts * n_levels, kk),
                    attn_i.float().contiguous(), values_all.float()).to(dt)


def scale_pos(pos: torch.Tensor, last_ss, cur_ss, no_bias: bool = False) -> torch.Tensor:
    """Rescale 2-D positions between canvases."""
    if tuple(last_ss) == tuple(cur_ss):
        return pos
    ratio = torch.tensor([cur_ss[1] / last_ss[1], cur_ss[0] / last_ss[0]],
                         dtype=pos.dtype, device=pos.device)
    if no_bias:
        return (pos + 0.5) * ratio - 0.5
    return pos * ratio


def grid_cells(loc: torch.Tensor, shape, grid_hw) -> torch.Tensor:
    """The finest-grid cell each sampling location (in the canvas of
    ``shape``) snaps to: rounded half to even, as jnp.round, and clamped into
    the grid; its raster index, int32."""
    sl = torch.round(scale_pos(loc, shape, grid_hw, no_bias=True)).int()
    gx = torch.clamp(sl[..., 0], 0, grid_hw[1] - 1)
    gy = torch.clamp(sl[..., 1], 0, grid_hw[0] - 1) * grid_hw[1]
    return gx + gy


@functools.lru_cache(maxsize=8)
def _grid9_static(h: int, w: int):
    """Border cells of an h x w grid, their 6x6 candidate windows (cell ids)
    and squared distances (out-of-grid pushed to 1e10), as numpy constants."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    flat_y, flat_x = ys.reshape(-1), xs.reshape(-1)
    border = np.nonzero((flat_y == 0) | (flat_y == h - 1) | (flat_x == 0)
                        | (flat_x == w - 1))[0].astype(np.int64)
    bx = flat_x[border].astype(np.float32)
    by = flat_y[border].astype(np.float32)
    offs = np.arange(-2, 4, dtype=np.float32)
    gx = bx[:, None, None] + offs[None, :, None]
    gy = by[:, None, None] + offs[None, None, :]
    d2 = (gx - bx[:, None, None]) ** 2 + (gy - by[:, None, None]) ** 2
    oob = (gx < 0) | (gx > w - 1) | (gy < 0) | (gy > h - 1)
    d2 = np.where(np.broadcast_to(oob, d2.shape), 1e10, d2)
    cells = (np.clip(gy, 0, h - 1) * w + np.clip(gx, 0, w - 1)).astype(np.int64)
    cells = np.broadcast_to(cells, d2.shape).reshape(len(border), 36)
    return border, cells.copy(), d2.reshape(len(border), 36).astype(np.float32)


class PointConv(nn.Module):
    """3x3-conv analogue on point clouds: 9-NN gather, rel-pos-conditioned
    mixing weights, channel mix."""

    def __init__(self, in_dim: int, out_dim: int, inner_ch: int = 4):
        super().__init__()
        self.inner_ch = inner_ch
        self.weight_net = WeightNet(inner_ch)
        self.norm = layer_norm(inner_ch * in_dim)
        self.linear = nn.Linear(inner_ch * in_dim, out_dim)

    def forward(self, x, pos, spatial_shape=None):
        """With ``spatial_shape`` and tokens that cover that grid (the AFF FPN
        level): interior cells mix their 3x3 neighbourhood with nine constant
        weight vectors (nine shifted adds in raster order); border cells take
        their exact 9-NN, ties by lowest token index.  A full grid narrower
        than 3 takes every token's exact 9 nearest grid tokens from a window
        (``grid_neighbors9``, JAX's route there).  Otherwise (any point
        cloud, such as the MRML finest level): each token's min(9, n)
        nearest tokens (``knn``), weights from their truncated offsets."""
        b, n, c = x.shape
        if spatial_shape is None or n != int(spatial_shape[0]) * int(spatial_shape[1]):
            return self._knn_route(x, pos)
        h_, w_ = int(spatial_shape[0]), int(spatial_shape[1])
        if h_ < 3 or w_ < 3:
            return self._knn_route(x, pos, grid_neighbors9(pos, h_, w_))
        dev = x.device
        border, cand_cells, cand_d2 = _grid9_static(h_, w_)
        nb = len(border)
        lut = pos_index_lut(pos, h_, w_)                              # cell -> token
        img = take_rows(x, lut).reshape(b, h_, w_, c)

        offs = np.asarray([(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)], np.float32)
        w_int = self.weight_net(rel_pos_features(torch.from_numpy(-offs).to(dev))).to(
            x.dtype)                                                  # (9, ic)
        pad = nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
        acc = None
        for s, (dx, dy) in enumerate(offs.astype(np.int64)):
            shifted = pad[:, 1 + dy: 1 + dy + h_, 1 + dx: 1 + dx + w_, :]
            term = shifted[..., None, :] * w_int[s][:, None]
            acc = term if acc is None else acc + term                 # (b, h, w, ic, c)
        acc = acc.reshape(b, n, self.inner_ch, c)

        cellb = torch.from_numpy(cand_cells).to(dev).expand(b, nb, 36)
        d2b = torch.from_numpy(cand_d2).to(dev).expand(b, nb, 36)
        tokb = take_scalars(lut, cellb.reshape(b, -1)).reshape(b, nb, 36)
        order = lex_sort(d2b, tokb)[..., :9]
        tok9 = torch.gather(tokb, -1, order)
        cell9 = torch.gather(cellb, -1, order)
        nb_pos = torch.stack([(cell9 % w_).float(), (cell9 // w_).float()], dim=-1)
        bpos = torch.from_numpy(
            np.stack([border % w_, border // w_], axis=-1).astype(np.float32)).to(dev)
        w_b = self.weight_net(rel_pos_features(torch.trunc(bpos[None, :, None, :] - nb_pos))).to(
            x.dtype)
        bacc = torch.einsum("bnsi,bnsc->bnic", w_b, take_rows(x, tok9))
        # in place on a non-leaf view: autograd records it (CopySlices), the
        # overwritten interior values get no gradient, as with JAX's .at[].set
        acc[:, torch.from_numpy(border).to(dev)] = bacc

        cell = pos[..., 1].long() * w_ + pos[..., 0].long()           # raster -> token order
        feat = take_rows(acc.reshape(b, n, -1), cell)
        return self.linear(self.norm(feat))

    def _knn_route(self, x, pos, nn_idx=None):
        b, n, _ = x.shape
        if nn_idx is None:
            nn_idx = knn(pos, pos, min(9, n))
        rel = torch.trunc(pos[:, :, None, :] - take_rows(pos, nn_idx))   # as the reference's .long()
        weights = self.weight_net(rel_pos_features(rel)).to(x.dtype)     # (b, n, k, ic)
        feat = cluster_wf(weights, x, nn_idx).reshape(b, n, -1)
        return self.linear(self.norm(feat))


class MSDeformAttnPc(nn.Module):
    """Deformable attention over point clouds.  ``shepard_power_learnable``:
    the power is a parameter; else the constant given."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int, n_points: int,
                 shepard_power: float, shepard_power_learnable: bool = True):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        if shepard_power_learnable:
            self.shepard_power = nn.Parameter(torch.full((1,), float(shepard_power)))
        else:
            self.shepard_power = float(shepard_power)
        self._reset_offsets()

    def _reset_offsets(self):
        """Offsets fan out along per-head directions with growing radius."""
        h, l, k = self.n_heads, self.n_levels, self.n_points
        thetas = np.arange(h, dtype=np.float32) * (2.0 * np.pi / h)
        grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
        grid = grid / np.abs(grid).max(-1, keepdims=True)
        grid = np.tile(grid.reshape(h, 1, 1, 2), (1, l, k, 1))
        for i in range(k):
            grid[:, :, i, :] *= i + 1
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(grid.reshape(-1)))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(self, querys, poss, values, spatial_shapes, nb_packed, nb_packed_t=None):
        """querys/values: per level (b, n_l, c); poss: per level (b, n_l, 2);
        spatial_shapes: per level (h, w), finest grid last; nb_packed: per
        level (b, grid_h*grid_w, 12) packed 4-NN tables; nb_packed_t: the same
        tables Morton-ordered and channel-major, (b, 12, grid_h*grid_w), which
        switch the channel-major prep on for the fine query levels."""
        b, _, c = querys[0].shape
        h, l, k = self.n_heads, self.n_levels, self.n_points
        c_ = c // h
        grid_hw = spatial_shapes[-1]
        power = self.shepard_power[0] if isinstance(self.shepard_power, nn.Parameter) \
            else self.shepard_power
        values_cat = self.value_proj(torch.cat(values, dim=1))
        ntot = values_cat.shape[1]
        level_sizes = [q.shape[1] for q in querys]
        levels_ok = _levels_ok(level_sizes, ntot)
        if USE_BH_LAYOUT and levels_ok:
            return self._forward_bh(querys, poss, values_cat, spatial_shapes, nb_packed, power,
                                    level_sizes)
        values_all = values_cat.reshape(b, ntot, h, c_).permute(0, 2, 1, 3).reshape(b * h, ntot, c_)
        values_all = values_all.contiguous()
        ncells = int(grid_hw[0]) * int(grid_hw[1])

        outputs = []
        for i in range(l):
            n_i = level_sizes[i]
            # the channel-major prep is for the fine query levels; the coarse
            # ones keep the row-major prep below (the JAX module's gate)
            if nb_packed_t is not None and levels_ok and n_i * 8 >= ncells:
                outputs.append(self._level_fused_t(i, querys, poss, values_all, spatial_shapes,
                                                   nb_packed_t, power, level_sizes))
                continue
            offs = dense(self.sampling_offsets, querys[i]).reshape(b, n_i, h, l, k, 2)
            attn = torch.softmax(self.attention_weights(querys[i]).reshape(b, n_i, h, l * k),
                                 dim=-1).reshape(b, n_i, h, l, k)
            attn_perm = attn.permute(0, 2, 1, 3, 4).reshape(b * h, n_i, l, k)
            idxs_local, ws_shepard = [], []
            for j in range(l):
                s_pos = scale_pos(poss[i], spatial_shapes[i], spatial_shapes[j], no_bias=True)
                loc = s_pos[:, :, None, None, :] + offs[:, :, :, j]          # (b, n_i, h, k, 2)
                loc = loc.permute(0, 2, 1, 3, 4).reshape(b * h, n_i * k, 2)
                # snap to the finest grid; one packed row gives the 4 neighbour
                # indices and their positions (the tables are geometry,
                # constant in the parameters)
                cells = grid_cells(loc, spatial_shapes[j], grid_hw)
                packed = take_rows(nb_packed[j].detach(), cells.reshape(b, h * n_i * k))
                packed = packed.reshape(b * h, n_i * k, 12)
                d2 = (loc[..., 0:1] - packed[..., 4:8]) ** 2 + (loc[..., 1:2] - packed[..., 8:12]) ** 2
                w = shepard_decay_weights(d2, power=power)
                idxs_local.append(packed[..., 0:4].int().reshape(b * h, n_i, k, 4))
                ws_shepard.append(w.reshape(b * h, n_i, k, 4))
            if USE_STACKED_GLUE:
                # the kernel is fp32 in and out: cast up at its call, back after
                idx_s = torch.cat([i_.reshape(b * h, n_i, k * 4) for i_ in idxs_local], 2)
                w_s = torch.cat([(w.float() * attn_perm[:, :, j, :, None].float())
                                 .reshape(b * h, n_i, k * 4) for j, w in enumerate(ws_shepard)], 2)
                sampled = msdetrpc_levels_s(idx_s.contiguous(), w_s.contiguous(),
                                            values_all.float(), level_sizes).to(values_all.dtype)
            else:
                sampled = _msdetrpc_dispatch(idxs_local, ws_shepard, attn_perm, values_all,
                                             level_sizes)
            sampled = sampled.reshape(b, h, n_i, c_).permute(0, 2, 1, 3).reshape(b, n_i, c)
            outputs.append(self.output_proj(sampled))
        return outputs

    def _level_fused_t(self, i, querys, poss, values_all, spatial_shapes, nb_packed_t, power,
                       level_sizes):
        """Channel-major sampling prep for query level i: everything from the
        offset and attention projections to the sampling kernel keeps the
        queries on the minor axis.  The projections emit (b, F, n) (the JAX
        module's ``DualLayoutDense(transposed=True)``, a plain matrix product),
        the packed rows come from the Morton-ordered channel-major tables, and
        ``msdetrpc_levels_t`` reads (bh, pairs, n) operands.  Same arithmetic as
        the row-major prep except where noted."""
        b = querys[i].shape[0]
        h, l, k = self.n_heads, self.n_levels, self.n_points
        c_ = self.d_model // h
        n_i = level_sizes[i]
        gh, gw = int(spatial_shapes[-1][0]), int(spatial_shapes[-1][1])
        log2w, log2h = gw.bit_length() - 1, gh.bit_length() - 1
        dev, dt = querys[i].device, poss[i].dtype

        def dense_t(lin, x):                                  # (b, n, c) -> (b, F, n)
            w, x, bias = promoted(lin.weight, x, lin.bias)
            return torch.matmul(w, x.transpose(1, 2)) + bias[None, :, None]

        offs_t = dense_t(self.sampling_offsets, querys[i]).reshape(b, h, l, k, 2, n_i)
        attn_t = torch.softmax(dense_t(self.attention_weights, querys[i]).reshape(b, h, l * k, n_i),
                               dim=2).reshape(b, h, l, k, n_i)
        s_pos_t = poss[i].transpose(1, 2)                     # (b, 2, n_i)

        idx_ts, w_ts = [], []
        for j in range(l):
            # level i's positions in level j's canvas: (p + 0.5) * r - 0.5 with
            # the ratio rounded to float32 first, the identity for equal shapes
            if tuple(spatial_shapes[i]) == tuple(spatial_shapes[j]):
                sp = s_pos_t
            else:
                r = torch.tensor([spatial_shapes[j][1] / spatial_shapes[i][1],
                                  spatial_shapes[j][0] / spatial_shapes[i][0]],
                                 dtype=dt, device=dev)[None, :, None]
                sp = (s_pos_t + 0.5) * r - 0.5
            loc_t = sp[:, None, None] + offs_t[:, :, j]       # (b, h, k, 2, n)
            if (int(spatial_shapes[j][0]), int(spatial_shapes[j][1])) == (gh, gw):
                sl = loc_t
            else:
                rg = torch.tensor([gw / spatial_shapes[j][1], gh / spatial_shapes[j][0]],
                                  dtype=dt, device=dev)[None, None, None, :, None]
                sl = (loc_t + 0.5) * rg - 0.5
            sl = torch.round(sl).int()                        # half to even, as jnp.round
            gx = torch.clamp(sl[:, :, :, 0], 0, gw - 1)       # (b, h, k, n)
            gy = torch.clamp(sl[:, :, :, 1], 0, gh - 1)
            rank = morton_rank(gx, gy, log2w, log2h)
            packed = windowed_row_gather(nb_packed_t[j], rank.reshape(b, h * k * n_i).contiguous())
            packed = packed.reshape(b, 12, h, k, n_i).permute(0, 2, 1, 3, 4).reshape(
                b * h, 12, k, n_i)
            nbi, nbx, nby = packed[:, 0:4], packed[:, 4:8], packed[:, 8:12]   # (bh, 4, k, n)
            lx = loc_t[:, :, :, 0].reshape(b * h, 1, k, n_i)
            ly = loc_t[:, :, :, 1].reshape(b * h, 1, k, n_i)
            d2 = (lx - nbx) ** 2 + (ly - nby) ** 2
            # shepard_decay_weights, normalised over the 4-NN axis (dim 1); a
            # constant power stays a float exponent here, as in the JAX module
            ipd = 1.0 / (torch.clamp(d2, min=1e-2) ** power + 1e-6)
            w = ipd / (ipd.sum(dim=1, keepdim=True) + 1e-6)
            w = w * attn_t[:, :, j].reshape(b * h, 1, k, n_i).to(w.dtype)
            # (bh, 4, k, n) -> (bh, k*4, n): only the majors move; the kernel
            # wants them contiguous
            idx_ts.append(nbi.int().permute(0, 2, 1, 3).reshape(b * h, k * 4, n_i).contiguous())
            w_ts.append(w.float().permute(0, 2, 1, 3).reshape(b * h, k * 4, n_i).contiguous())
        sampled = msdetrpc_levels_t(idx_ts, w_ts, values_all.float(), level_sizes).to(
            values_all.dtype)                                                  # (bh, n, c_)
        sampled = sampled.reshape(b, h, n_i, c_).permute(0, 2, 1, 3).reshape(b, n_i, self.d_model)
        return self.output_proj(sampled)

    def _forward_bh(self, querys, poss, values_cat, spatial_shapes, nb_packed, power, level_sizes):
        """Head-natural route: tensors stay (b, n, h, ...) as the Linears emit
        them, no head transposes; ``msdetrpc_bh`` reads them so."""
        b, ntot, c = values_cat.shape
        h, l, k = self.n_heads, self.n_levels, self.n_points
        c_ = c // h
        grid_hw = spatial_shapes[-1]
        values_bh = values_cat.reshape(b, ntot, h, c_)
        outputs = []
        for i in range(l):
            n_i = level_sizes[i]
            offs = dense(self.sampling_offsets, querys[i]).reshape(b, n_i, h, l, k, 2)
            attn = torch.softmax(self.attention_weights(querys[i]).reshape(b, n_i, h, l * k),
                                 dim=-1).reshape(b, n_i, h, l, k)
            idxs_bh, ws_bh = [], []
            for j in range(l):
                s_pos = scale_pos(poss[i], spatial_shapes[i], spatial_shapes[j], no_bias=True)
                loc = (s_pos[:, :, None, None, :] + offs[:, :, :, j]).reshape(b, n_i * h * k, 2)
                packed = take_rows(nb_packed[j].detach(),
                                   grid_cells(loc, spatial_shapes[j], grid_hw))  # (b, nhk, 12)
                d2 = (loc[..., 0:1] - packed[..., 4:8]) ** 2 + (loc[..., 1:2] - packed[..., 8:12]) ** 2
                w = shepard_decay_weights(d2, power=power).reshape(b, n_i, h, k, 4)
                w = w * attn[:, :, :, j, :, None].to(w.dtype)
                idxs_bh.append(packed[..., 0:4].int().reshape(b, n_i, h, k * 4))
                ws_bh.append(w.float().reshape(b, n_i, h, k * 4))
            sampled = msdetrpc_bh(idxs_bh, ws_bh, values_bh.float(), level_sizes).to(
                values_bh.dtype)
            outputs.append(self.output_proj(sampled.reshape(b, n_i, c)))
        return outputs


def pack_neighbor_table(nb_idx: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """nb_idx: (b, hw, 4) level-token indices; pos: (b, n_l, 2) -> (b, hw, 12)
    rows [idx x4 | x x4 | y x4] (indices exact in f32 below 2^24)."""
    nb_pos = take_rows(pos, nb_idx)
    return torch.cat([nb_idx.float(), nb_pos[..., 0], nb_pos[..., 1]], dim=-1)


def activation_fn(name: str):
    """The pixel decoders' nonlinearity: ``relu``, or ``lrelu`` (leaky, slope
    0.01) of the OracleTeacher decoder."""
    if name == "lrelu":
        return lambda x: nn.functional.leaky_relu(x, 0.01)
    if name != "relu":
        raise ValueError(f"activation {name!r}: relu or lrelu")
    return torch.relu


class MSDeformAttnEncoderLayerPc(nn.Module):
    """Deformable self-attention + FFN encoder layer (post-norm; the FFN's
    ``activation``: relu or lrelu).  ``dropout`` in train mode, per level:
    on the attention's output (``dropout1``), inside the FFN (``dropout2``)
    and on its output (``dropout3``), as the JAX layer's three drops."""

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int, n_points: int,
                 shepard_power: float, shepard_power_learnable: bool = True,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.act = activation_fn(activation)
        self.self_attn = MSDeformAttnPc(d_model, n_levels, n_heads, n_points, shepard_power,
                                        shepard_power_learnable)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.dropout1, self.dropout2, self.dropout3 = (Dropout(dropout), Dropout(dropout),
                                                       Dropout(dropout))

    def forward(self, srcs, poss, spatial_shapes, pos_embeds, nb_packed, nb_packed_t=None):
        with_pe = [s + p for s, p in zip(srcs, pos_embeds)]
        src2s = self.self_attn(with_pe, poss, srcs, spatial_shapes, nb_packed, nb_packed_t)
        outs = []
        for src, src2 in zip(srcs, src2s):
            src = self.norm1(src + self.dropout1(src2))
            ffn = self.linear2(self.dropout2(self.act(self.linear1(src))))
            outs.append(self.norm2(src + self.dropout3(ffn)))
        return outs


def raster_grid(shape, b: int, dev) -> torch.Tensor:
    """(x, y) of every cell of an h x w grid in raster order -> (b, h*w, 2)."""
    ys, xs = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    grid = torch.from_numpy(np.stack([xs, ys], 2).reshape(1, -1, 2).astype(np.float32)).to(dev)
    return grid.expand(b, grid.shape[1], 2)


class MSDeformAttnPixelDecoder(nn.Module):
    """The point-cloud pixel decoder.  forward(features) -> (mask_features,
    mf_pos, transformer_out[0], multi_scale_features, poss[:3]).

    Parameters, under the names the weights bridge gives them: per
    transformer level (coarse first) a Linear+LN input projection,
    ``transformer.level_embed`` and the encoder layers, per FPN level (the
    finest ``num_fpn_levels`` of ``in_features``, coarse first; by default
    those between the finest transformer level's stride and
    ``common_stride``) an adapter and a PointConv + LN, and the mask
    features' Linear.  ``mask_on_full_grid`` (the MSDeformAttnPixelDecoderUp
    form): every level, the FPN ones too, is Shepard-upsampled onto the
    whole finest grid, and the mask features are read off that grid.
    ``activation``: the nonlinearity of the encoder layers' FFN and of the
    FPN (relu or lrelu); ``dropout``: the encoder layers' rate."""

    def __init__(self, feature_channels: Dict[str, int],
                 in_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
                 feature_strides: Sequence[int] = (4, 8, 16, 32), conv_dim: int = 256,
                 mask_dim: int = 256, transformer_nheads: int = 8,
                 transformer_dim_feedforward: int = 1024, transformer_enc_layers: int = 6,
                 common_stride: int = 4, n_points: int = 4, shepard_power: float = 3.0,
                 shepard_power_learnable: bool = True, maskformer_num_feature_levels: int = 3,
                 num_fpn_levels: Optional[int] = None, mask_on_full_grid: bool = False,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.maskformer_num_feature_levels = maskformer_num_feature_levels
        self.mask_on_full_grid = mask_on_full_grid
        self.act = activation_fn(activation)
        if num_fpn_levels is None:
            strides = dict(zip(in_features, feature_strides))
            num_fpn_levels = int(math.log2(min(strides[f] for f in transformer_in_features))
                                 - math.log2(common_stride))
        self.in_features = tuple(in_features)
        self.transformer_in_features = tuple(transformer_in_features)
        self.num_fpn_levels = num_fpn_levels
        self.conv_dim = conv_dim
        num_levels = len(self.transformer_in_features)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Linear(feature_channels[f], conv_dim), layer_norm(conv_dim))
            for f in self.transformer_in_features[::-1])
        self.transformer = nn.Module()
        self.transformer.level_embed = nn.Parameter(torch.randn(num_levels, conv_dim))
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layers = nn.ModuleList(
            MSDeformAttnEncoderLayerPc(conv_dim, transformer_dim_feedforward, num_levels,
                                       transformer_nheads, n_points, shepard_power,
                                       shepard_power_learnable, activation, dropout)
            for _ in range(transformer_enc_layers))
        for idx, f in enumerate(self.in_features[:num_fpn_levels][::-1]):
            self.add_module(f"adapter_{idx + 1}", nn.Sequential(
                nn.Linear(feature_channels[f], conv_dim), layer_norm(conv_dim)))
            self.add_module(f"layer_{idx + 1}", nn.Sequential(
                PointConv(conv_dim, conv_dim), layer_norm(conv_dim)))
        self.mask_features = nn.Linear(conv_dim, mask_dim)

    def forward(self, features: Dict):
        finest = self.in_features[0]
        grid_hw = features[finest + "_spatial_shape"]
        dev = features[finest].device
        grid_pos = raster_grid(grid_hw, features[finest].shape[0], dev)

        srcs, poss, pos_embed, spatial_shapes, nb_tables = [], [], [], [], []
        for idx, f in enumerate(self.transformer_in_features[::-1]):   # res5, res4, res3
            pos = features[f + "_pos"].float()
            ss = features[f + "_spatial_shape"]
            srcs.append(self.input_proj[idx](features[f]))
            poss.append(pos)
            # fp32 geometry, cast down to the compute dtype
            pos_embed.append(position_embedding_sine(pos, self.conv_dim // 2).to(srcs[-1].dtype))
            spatial_shapes.append(ss)
            scaled = scale_pos(pos, ss, grid_hw, no_bias=True)
            nb_tables.append(pack_neighbor_table(knn(grid_pos, scaled, 4), pos))

        lvl_pos = [pe + self.transformer.level_embed[i][None, None]
                   for i, pe in enumerate(pos_embed)]
        last_pos, last_ss = poss[-1], spatial_shapes[-1]
        # every level's positions and canvas, the FPN levels' appended below
        all_levels = list(zip(poss, spatial_shapes))
        spatial_shapes = list(spatial_shapes) + [grid_hw]

        # Morton-ordered channel-major tables for the channel-major prep: one
        # row permutation and one transpose per forward, shared by the layers
        nb_tables_t = None
        gh, gw = int(grid_hw[0]), int(grid_hw[1])
        if USE_FUSED_PREP and is_pow2(gh) and is_pow2(gw) and (gh * gw) % 128 == 0:
            perm = torch.from_numpy(morton_perm(gh, gw)).to(dev)
            nb_tables_t = [t[:, perm, :].transpose(1, 2).contiguous() for t in nb_tables]

        out = srcs
        for layer in self.transformer.encoder.layers:
            out = layer(out, poss, spatial_shapes, lvl_pos, nb_tables, nb_tables_t)
        transformer_out = out[0]

        out = list(out)
        for idx, f in enumerate(self.in_features[:self.num_fpn_levels][::-1]):
            pos = features[f + "_pos"].float()
            ss = features[f + "_spatial_shape"]
            cur_fpn = getattr(self, f"adapter_{idx + 1}")(features[f])
            last_pos = scale_pos(last_pos, last_ss, ss, no_bias=True)
            y = cur_fpn + upsample_feature_shepard(pos, last_pos, out[-1]).to(cur_fpn.dtype)
            conv, norm = getattr(self, f"layer_{idx + 1}")
            y = self.act(norm(conv(y, pos, ss)))
            last_pos, last_ss = pos, ss
            all_levels.append((pos, ss))
            out.append(y)

        if self.mask_on_full_grid:
            on_grid = torch.cat([scale_pos(p, s, grid_hw, no_bias=True) for p, s in all_levels],
                                dim=1)
            mask_features = dense(self.mask_features,
                                  upsample_feature_shepard(grid_pos, on_grid, torch.cat(out, dim=1)))
            last_pos = grid_pos
        else:
            mask_features = self.mask_features(out[-1])
        return (mask_features, last_pos, transformer_out,
                out[:self.maskformer_num_feature_levels],
                poss[:self.maskformer_num_feature_levels])


def pixel_decoder_from_config(cfg, feature_channels: Dict[str, int],
                              mask_on_full_grid: bool = False) -> MSDeformAttnPixelDecoder:
    h = cfg.MODEL.SEM_SEG_HEAD
    return MSDeformAttnPixelDecoder(
        feature_channels,
        in_features=tuple(h.IN_FEATURES),
        transformer_in_features=tuple(h.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES),
        conv_dim=h.CONVS_DIM,
        mask_dim=h.MASK_DIM,
        transformer_nheads=cfg.MODEL.MASK_FORMER.NHEADS,
        transformer_dim_feedforward=1024,
        transformer_enc_layers=h.TRANSFORMER_ENC_LAYERS,
        dropout=cfg.MODEL.MASK_FORMER.DROPOUT,
        common_stride=h.COMMON_STRIDE,
        # distances are squared, so halve the configured power
        shepard_power=cfg.MODEL.AFF.SHEPARD_POWER / 2.0,
        shepard_power_learnable=cfg.MODEL.AFF.SHEPARD_POWER_LEARNABLE,
        mask_on_full_grid=mask_on_full_grid,
    )
