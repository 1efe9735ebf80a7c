"""AutoFocusFormer backbone: point-cloud transformer with adaptive downsampling.

Counterpart of ``autofocusformermod_tpu/models/aff.py``.  Features are
(b, n, c) point clouds with (b, n, 2) positions.  Each stage clusters its
tokens along a space-filling curve, finds each token's nearest clusters
(``knn``), runs local cluster attention (the ``local_attn`` kernel on CUDA)
and then merges the kept tokens (ClusterMerging).  Parameter names follow
the reference PyTorch state dict.  Under mixed precision the local
attention kernel takes fp32 operands (cast up at its call, its outputs cast
back down) and the fp32 geometry terms (the rel-pos bias, the merging
weights) are cast to the features' dtype, as in the JAX module.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..geometry.cluster import nbhd_from_cluster_ids, space_filling_cluster
from ..geometry.knn import knn
from ..ops.clusten import cluster_wf
from ..ops.gather import take_rows, topk_indices
from ..ops.dispatch import local_cluster_attention_reference, use_kernel
from ..ops.local_attn import build_reverse_lists, sfc_cluster_attention
from .layers import (DropPath, Dropout, FlaxBatchNorm2d, Mlp, WeightNet, dense, layer_norm,
                     rel_pos_features)


class ClusterAttention(nn.Module):
    """Local attention over each token's neighbour clusters, with a learned
    rel-pos bias and a learnable blank attention sink.  In train mode
    ``attn_drop`` drops attention probabilities (the blank sink's too) and
    ``proj_drop`` the output.  The local_attn kernel computes no
    probabilities to drop, as JAX's Pallas kernel applies no attention
    dropout: a CUDA call in train mode at ``attn_drop`` > 0 raises, and the
    plain path (CPU tensors, ``plain_versions``) drops them in the gather
    composition, as JAX's gather path does."""

    def __init__(self, dim: int, num_heads: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.dim, self.num_heads = dim, num_heads
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.blank_k = nn.Parameter(torch.randn(dim))
        self.blank_v = nn.Parameter(torch.randn(dim))
        self.pos_embed = nn.Linear(5, num_heads)
        self.proj = nn.Linear(dim, dim)
        self.attn_drop, self.proj_drop = Dropout(attn_drop), Dropout(proj_drop)

    def _dropped_attention(self, q, key, v, blank_k, ctx):
        """The gather composition with the probabilities dropped -> (out,
        blank_prob); padded slots excluded exactly, as everywhere in the
        port."""
        if use_kernel(q, key, v):
            raise NotImplementedError(
                f"attention dropout (ATTN_DROP_RATE {self.attn_drop.rate}) in train mode on the "
                "local_attn kernel: JAX's Pallas path applies none and the kernel has no "
                "probabilities to drop; train with ATTN_DROP_RATE 0 on the card")
        member, mask, rel5 = nbhd_from_cluster_ids(ctx["pos"], ctx["nc"], ctx["span"], q.shape[2])
        bias = dense(self.pos_embed, rel5).to(q.dtype)                         # (b, n, m, h)
        blank_attn = torch.einsum("bhnc,hc->bhn", q, blank_k)[..., None]
        return local_cluster_attention_reference(q, key, v, member, bias, mask, blank_attn,
                                                 drop=self.attn_drop)

    def forward(self, feat: torch.Tensor, ctx: Dict) -> torch.Tensor:
        b, n, c = feat.shape
        h = self.num_heads
        c_ = c // h
        q = (self.q(feat) * c_ ** -0.5).reshape(b, n, h, c_).permute(0, 2, 1, 3)
        # the kv projection interleaves k/v PER HEAD: columns are (h, 2, c_)
        kv = self.kv(feat).reshape(b, n, h, 2, c_).permute(3, 0, 2, 1, 4)
        key, v = kv[0], kv[1]                                   # (b, h, n, c_)
        blank_k = self.blank_k.reshape(h, c_)
        if ctx["global"]:
            pos_bias = dense(self.pos_embed, ctx["rel_feat5"]).to(feat.dtype)   # (b, n, n, h)
            attn = torch.einsum("bhnc,bhmc->bhnm", q, key) + pos_bias.permute(0, 3, 1, 2)
            blank_attn = torch.einsum("bhnc,hc->bhn", q, blank_k)[..., None]
            attn = self.attn_drop(torch.softmax(torch.cat([attn, blank_attn], dim=-1), dim=-1))
            out = torch.einsum("bhnm,bhmc->bhnc", attn[..., :-1], v)
            blank_prob = attn[..., -1:]
        elif self.training and self.attn_drop.rate > 0:
            out, blank_prob = self._dropped_attention(q, key, v, blank_k, ctx)
        else:
            # the kernel is fp32 in and out: cast bf16 operands up at its call
            out, blank_prob = sfc_cluster_attention(
                q.float().contiguous(), key.float().contiguous(), v.float().contiguous(),
                ctx["pos"], ctx["nc"], self.pos_embed.weight.float().contiguous(),
                self.pos_embed.bias.float().contiguous(), blank_k.float().contiguous(),
                ctx["span"], reverse=ctx.get("reverse"))
            out, blank_prob = out.to(feat.dtype), blank_prob.to(feat.dtype)
        out = out + blank_prob * self.blank_v.reshape(1, h, 1, c_)
        return self.proj_drop(self.proj(out.permute(0, 2, 1, 3).reshape(b, n, c)))


class ClusterTransformerBlock(nn.Module):
    """Pre-LN attention + FFN block.  With ``layer_scale`` > 0 each residual
    branch is scaled per channel by a learned ``gamma1`` / ``gamma2`` that
    starts at that value; each branch goes through DropPath.  ``drop``: the
    attention's output and the MLP's dropout; ``attn_drop``: the attention
    probabilities' (``ClusterAttention``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 drop_path: float = 0.0, layer_scale: float = 0.0, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = ClusterAttention(dim, num_heads, attn_drop, drop)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop)
        self.drop_path = DropPath(drop_path)
        scaled = layer_scale > 0
        self.gamma1 = nn.Parameter(layer_scale * torch.ones(dim)) if scaled else None
        self.gamma2 = nn.Parameter(layer_scale * torch.ones(dim)) if scaled else None

    def forward(self, feat, ctx):
        branch = self.attn(self.norm1(feat), ctx)
        if self.gamma1 is not None:
            branch = self.gamma1 * branch
        feat = feat + self.drop_path(branch)
        branch = self.mlp(self.norm2(feat))
        if self.gamma2 is not None:
            branch = self.gamma2 * branch
        return feat + self.drop_path(branch)


class ClusterMerging(nn.Module):
    """Adaptive downsampling: grid prior + learned importance, with
    ``reserve_on`` reserved coarse-grid tokens forced to survive, top-k
    keep, PointConv merge of the kept tokens' neighbourhoods."""

    def __init__(self, dim: int, out_dim: int, alpha: float = 4.0, ds_rate: float = 0.25,
                 inner_ch: int = 4, reserve_on: bool = True):
        super().__init__()
        self.alpha, self.ds_rate, self.reserve_on = alpha, ds_rate, reserve_on
        self.weight_net = WeightNet(inner_ch)
        self.norm = layer_norm(inner_ch * dim)
        self.linear = nn.Linear(inner_ch * dim, out_dim)

    def forward(self, pos, feat, nc, learned_prob, stride: int, reserve_num: int, span: int):
        b, n, c = feat.shape
        keep_num = int(n * self.ds_rate)
        pos_int = pos.int()
        if stride == 2:
            grid_prob = (pos_int % stride == 0).all(-1).float()
        else:
            _, min_dist = knn(pos, pos, 2, return_dist=True)
            min_dist = min_dist[:, :, 1]
            ada_stride = 2.0 ** (torch.ceil(torch.log2(torch.clamp(min_dist, min=1e-6))) + 1)
            grid_prob = (pos_int % ada_stride[..., None].int() == 0).all(-1).float()
        final_prob = grid_prob + learned_prob.detach().reshape(b, n) * self.alpha
        if self.reserve_on:
            # the coarse grid (every 2*stride) is reserved: it always survives
            reserve_mask = (pos_int % (stride * 2) == 0).all(-1).float()
            final_prob = final_prob + reserve_mask * (-100.0)
            idx = torch.cat([topk_indices(final_prob, keep_num - reserve_num),
                             topk_indices(reserve_mask, reserve_num)], dim=1)
        else:
            idx = topk_indices(final_prob, keep_num)

        new_pos = take_rows(pos, idx)
        member_idx, mask, rel5 = nbhd_from_cluster_ids(pos, take_rows(nc, idx), span, n,
                                                       query_pos=new_pos)
        weights = self.weight_net(rel5)                           # (b, n', m, ic)
        if mask is not None:
            weights = weights * mask[..., None]
        # fp32 geometry: cast down so the merge stays in the compute dtype
        feat = cluster_wf(weights.to(feat.dtype), feat * learned_prob, member_idx).reshape(
            b, keep_num, -1)
        return new_pos, self.linear(self.norm(feat))


def attention_context(pos, b: int, cluster_size: int, nbhd_size: int, h: int, w: int):
    """The neighbourhoods one stage's blocks attend over, from positions
    (1 or b, n, 2) on an h x w canvas -> (ctx for ClusterAttention, the
    positions (b, n, 2) in the blocks' token order, rank (b, n): the
    incoming index of each token in that order, None where it is kept).
    nbhd_size >= n: global attention.  Else the tokens are sorted along the
    space-filling curve into clusters of cluster_size and each finds its
    nearest clusters (``knn``); with gradients on and on the kernel route,
    the backward kernels' reverse lists (a function of nc alone) are built
    here once for all the stage's blocks.  The neighbourhood is min(
    round(nbhd_size / cluster_size), the cluster count) clusters, so a
    cluster larger than nbhd_size gives one cluster of cluster_size tokens;
    where there are as many clusters as tokens (cluster_size 1), every
    token is its own cluster, in the incoming order."""
    n = pos.shape[1]
    if nbhd_size >= n:
        ctx = {"global": True,
               "rel_feat5": rel_pos_features(pos[:, None, :, :] - pos[:, :, None, :])}
        return ctx, pos.expand(b, n, 2), None
    m = cluster_size
    k = int(math.ceil(n / float(m)))
    nnc = min(int(round(nbhd_size / float(m))), k)
    if k == n:
        span, cluster_mean_pos, rank = 1, pos, None
    else:
        span = m
        pos, cluster_mean_pos, _, _, pos_ranking = space_filling_cluster(pos, m, h, w)
        rank = pos_ranking[..., 0].long().expand(b, n)
    nc = knn(pos, cluster_mean_pos, nnc).expand(b, n, nnc).contiguous()
    pos = pos.expand(b, n, 2).contiguous()
    ctx = {"global": False, "pos": pos, "nc": nc, "span": span}
    if torch.is_grad_enabled() and use_kernel(pos, nc):
        ctx["reverse"] = build_reverse_lists(nc, n, span)
    return ctx, pos, rank


class BasicLayer(nn.Module):
    """One AFF stage: cluster -> neighbour clusters -> blocks -> downsample."""

    def __init__(self, dim: int, out_dim: Optional[int], cluster_size: int, nbhd_size: int,
                 depth: int, num_heads: int, mlp_ratio: float, alpha: float = 4.0,
                 ds_rate: float = 0.25, has_downsample: bool = True,
                 drop_path: Sequence[float] = (), layer_scale: float = 0.0,
                 drop: float = 0.0, attn_drop: float = 0.0, reserve_on: bool = True):
        super().__init__()
        self.cluster_size, self.nbhd_size = cluster_size, nbhd_size
        drop_path = tuple(drop_path) or (0.0,) * depth
        self.blocks = nn.ModuleList(
            ClusterTransformerBlock(dim, num_heads, mlp_ratio, drop_path[i], layer_scale, drop,
                                    attn_drop)
            for i in range(depth))
        self.has_downsample = has_downsample
        if has_downsample:
            self.prob_net = nn.Linear(dim, 1)
            self.downsample = ClusterMerging(dim, out_dim, alpha, ds_rate, reserve_on=reserve_on)

    def forward(self, pos, feat, h: int, w: int, stride: int):
        b, n, _ = feat.shape
        ctx, pos, rank = attention_context(pos, b, self.cluster_size, self.nbhd_size, h, w)
        if rank is not None:
            feat = take_rows(feat, rank)
        nc, span = ctx.get("nc"), ctx.get("span")

        for blk in self.blocks:
            feat = blk(feat, ctx)

        if not self.has_downsample:
            return pos, feat, pos, feat
        if ctx["global"]:
            raise ValueError("AFF stage with downsampling needs n > nbhd_size "
                             f"(got n={n}, nbhd_size={self.nbhd_size})")
        learned_prob = torch.sigmoid(self.prob_net(feat))
        reserve_num = math.ceil(h / (stride * 2)) * math.ceil(w / (stride * 2))
        pos_down, feat_down = self.downsample(pos, feat, nc, learned_prob, stride,
                                              reserve_num, span)
        return pos, feat, pos_down, feat_down


class PatchEmbed(nn.Module):
    """Two stride-2 3x3 convs with BatchNorm (flax's momentum, as the JAX
    stem) + exact GELU between.  Input NHWC, as the JAX package; output
    tokens in raster order with integer grid positions (x, y)."""

    def __init__(self, embed_dim: int = 32, patch_norm: bool = True):
        super().__init__()
        self.proj1 = nn.Conv2d(3, embed_dim // 2, 3, stride=2, padding=1)
        self.bn = FlaxBatchNorm2d(embed_dim // 2)
        self.proj2 = nn.Conv2d(embed_dim // 2, embed_dim, 3, stride=2, padding=1)
        self.norm = layer_norm(embed_dim) if patch_norm else nn.Identity()

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        x = self.proj2(nn.functional.gelu(self.bn(self.proj1(x))))
        b, c, h, w = x.shape
        x = self.norm(x.flatten(2).transpose(1, 2))
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pos = torch.from_numpy(
            np.stack([xs, ys], axis=2).reshape(1, h * w, 2).astype(np.float32)).to(x.device)
        return pos, x, h, w


class AFF(nn.Module):
    """The 4-stage AutoFocusFormer backbone.  forward(NHWC images) ->
    {"res2".."res5": feat, "res*_pos": pos, "res*_spatial_shape": (h, w)}.
    ``drop_rate``: dropout after the patch embedding, on each block's
    attention output and in its MLP; ``attn_drop_rate``: on the attention
    probabilities (``ClusterAttention``); ``reserve_on``: the merges keep
    the coarse grid.

    The blocks' DropPath rates rise linearly over the depth from 0 to
    ``drop_path_rate``; ``layers.set_dropout_generator`` gives them and the
    Dropouts their stream."""

    def __init__(self, embed_dim: Sequence[int] = (32, 128, 256, 512), cluster_size: int = 8,
                 nbhd_size: Sequence[int] = (48, 48, 48, 48), alpha: float = 4.0,
                 ds_rate: float = 0.25, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), mlp_ratio: float = 2.0,
                 patch_norm: bool = True, drop_path_rate: float = 0.0,
                 layer_scale: float = 0.0, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 reserve_on: bool = True):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        nl = len(depths)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        self.patch_embed = PatchEmbed(embed_dim[0], patch_norm)
        self.pos_drop = Dropout(drop_rate)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim[i], embed_dim[i + 1] if i < nl - 1 else None, cluster_size,
                       nbhd_size[i], depths[i], num_heads[i], mlp_ratio, alpha, ds_rate,
                       has_downsample=i < nl - 1,
                       drop_path=dpr[sum(depths[:i]):sum(depths[:i + 1])],
                       layer_scale=layer_scale, drop=drop_rate, attn_drop=attn_drop_rate,
                       reserve_on=reserve_on)
            for i in range(nl))
        for i in range(nl):
            self.add_module(f"norm{i}", layer_norm(embed_dim[i]))

    def forward(self, x: torch.Tensor) -> Dict:
        pos, feat, h, w = self.patch_embed(x)
        feat = self.pos_drop(feat)
        outs: Dict = {}
        for i, layer in enumerate(self.layers):
            pos_out, x_out, pos, feat = layer(pos, feat, h, w, stride=2 ** (i + 1))
            outs[f"res{i + 2}"] = getattr(self, f"norm{i}")(x_out)
            outs[f"res{i + 2}_pos"] = pos_out
            outs[f"res{i + 2}_spatial_shape"] = (h, w)
        return outs


def aff_from_config(cfg) -> AFF:
    """Build AFF from a config (the port's CfgNode or the JAX package's)."""
    a = cfg.MODEL.AFF
    return AFF(embed_dim=tuple(a.EMBED_DIM), cluster_size=a.CLUSTER_SIZE,
               nbhd_size=tuple(a.NBHD_SIZE), alpha=a.ALPHA, ds_rate=a.DS_RATE,
               depths=tuple(a.DEPTHS), num_heads=tuple(a.NUM_HEADS),
               mlp_ratio=a.MLP_RATIO, patch_norm=a.PATCH_NORM,
               drop_path_rate=a.DROP_PATH_RATE, layer_scale=a.LAYER_SCALE,
               drop_rate=a.DROP_RATE, attn_drop_rate=a.ATTN_DROP_RATE, reserve_on=a.RESERVE)
