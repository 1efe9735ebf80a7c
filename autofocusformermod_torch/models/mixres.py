"""MixRes backbones: the mixed-resolution token models of the MaskFiner
cascade.

Counterpart of ``autofocusformermod_tpu/models/mixres.py``:

- ``MixResViT`` is cascade stage 0, a coarse global-attention ViT with an
  overlapping conv patch embedding and depthwise-conv feed-forwards; its
  tokens carry (scale, x, y) positions on the min-patch canvas;
- ``MixResNeighbour`` is every later stage: the ``upscale_ratio`` share of
  the newest scale's tokens that the previous stage's decoder disagreed on
  most are split 4 ways (straight-through gradients), raw image pixels are
  projected into the new tokens, and ``MixResLayer`` runs cluster attention
  (``models/aff.py:ClusterTransformerBlock``, the ``local_attn`` kernel on
  CUDA, ``knn`` for the clusters) over the mixed-scale point cloud.

Tokens stay ordered by scale in contiguous segments whose lengths
(``tokens_per_scale``) follow from the image size.  The global attention of
stage 0 is a plain matrix product, as in the JAX package (an einsum there,
outside any Pallas kernel).  ``MODEL.MR.DROP_RATE`` drops in the
feed-forwards and on the cluster attention's output, ``ATTN_DROP_RATE``
the cluster attention's probabilities (``aff.ClusterAttention``: on the
plain path only, as in the JAX package).  Register tokens are prepended to
stage 0's tokens and cut off after its blocks, as the JAX package does; its
depthwise conv then meets h * w + R tokens on an h x w grid and raises, as
the JAX reshape does.

Either model may stand at any stage.  A first stage (``first_layer``)
embeds the image itself (a MixResNeighbour with BatchNorm in its patch
embedding) and splits nothing; a MixResViT after the first takes the
incoming stream, which must be its full patch grid.  The XAttn variant
(``cross_attend_image``, MixResNeighbourXAttn) lets the newest scale's
tokens cross-attend, before every cluster block, to the image patch
features under them (a plain attention, an einsum in the JAX package).
``dynamic_k_split`` is the eval-time dynamic split count, bucketed as the
JAX package buckets it; a stage takes it as its ``k_split``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.gather import take_rows
from .aff import ClusterTransformerBlock, attention_context
from .layers import (GN_EPS, DropPath, Dropout, FlaxBatchNorm2d, Mlp, layer_norm,
                     position_embedding_sine)
from .transformer_decoder import MultiheadAttention


def dynamic_k_split(scores, n_curr: int, threshold: float = 0.5, cap_ratio: float = 1.0,
                    buckets: Sequence[float] = (0.1, 0.25, 0.5, 0.75, 1.0)) -> int:
    """The eval-time split count of a stage from its predecessor's scores
    (b, n_curr), an array on the host: the batch's largest share of scores
    above ``threshold``, clamped to [0.1, cap_ratio], rounded up to the next
    of ``buckets`` (the largest where none is as large) and capped again;
    max(1, int(n_curr * ratio))."""
    frac = float(np.max(np.mean(np.asarray(scores) > threshold, axis=-1)))
    frac = min(max(frac, 0.1), cap_ratio)
    ordered = sorted(buckets)
    ratio = next((r for r in ordered if r >= frac), ordered[-1])
    return max(1, int(n_curr * min(ratio, cap_ratio)))


def get_2dpos_of_curr_ps_in_min_ps(height: int, width: int, patch_size: int,
                                   min_patch_size: int, scale: int) -> np.ndarray:
    """(scale, x, y) of a regular patch grid on the min-patch canvas, raster
    order -> (n, 3) float32."""
    step = patch_size // min_patch_size
    gx, gy = np.meshgrid(np.arange(0, width // min_patch_size, step),
                         np.arange(0, height // min_patch_size, step), indexing="xy")
    coords = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    return np.concatenate([np.full((len(coords), 1), scale), coords], axis=1).astype(np.float32)


def split_order(scores: torch.Tensor) -> torch.Tensor:
    """Tokens by ascending disagreement, ties to the lower index (a stable
    sort, as jnp.argsort): (b, n) -> (b, n) int64.  The last k are split, in
    this order, which is the order of the next stage's new tokens."""
    return torch.argsort(scores, dim=1, stable=True)


class DownSampleConvBlock(nn.Module):
    """Conv 3x3 stride 2 -> LeakyReLU(0.01) -> GroupNorm(1) (BatchNorm with
    ``use_bn``), NCHW."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_dim, out_dim, 3, stride=2, padding=1)
        self.norm = FlaxBatchNorm2d(out_dim) if use_bn else nn.GroupNorm(1, out_dim, eps=GN_EPS)

    def forward(self, x):
        return self.norm(nn.functional.leaky_relu(self.conv(x), 0.01))


class OverlapPatchEmbedding(nn.Module):
    """log2(patch_size) stride-2 conv blocks, then LayerNorm; NHWC image ->
    (b, h * w, embed_dim) tokens in raster order.  ``use_bn``: the blocks
    normalise with BatchNorm (a MixResNeighbour first stage's)."""

    def __init__(self, patch_size: int, embed_dim: int, in_dim: int = 3, use_bn: bool = False):
        super().__init__()
        n_layers = int(math.log2(patch_size))
        dims = [in_dim] + [embed_dim // 2 ** (n_layers - 1 - i) for i in range(n_layers)]
        self.conv = nn.ModuleList(DownSampleConvBlock(a, b, use_bn)
                                  for a, b in zip(dims[:-1], dims[1:]))
        self.out_norm = layer_norm(embed_dim)

    def forward(self, im):
        x = im.permute(0, 3, 1, 2)
        for block in self.conv:
            x = block(x)
        return self.out_norm(x.flatten(2).transpose(1, 2))


class DWConvFFN(nn.Module):
    """fc1 -> depthwise 3x3 conv on the token grid -> exact GELU -> Dropout
    -> fc2 -> Dropout; without ``dw_conv`` (the MRML blocks, whose tokens
    are mixed-scale) no conv.  The conv takes exactly the h x w tokens of
    the grid."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int, dw_conv: bool = True,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.dwconv = (nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1, groups=hidden_dim)
                       if dw_conv else None)
        self.fc2 = nn.Linear(hidden_dim, out_dim)
        self.drop1, self.drop2 = Dropout(drop), Dropout(drop)

    def forward(self, x, h: int, w: int):
        b, n, _ = x.shape
        x = self.fc1(x)
        if self.dwconv is not None:
            if n != h * w:
                raise ValueError(f"the depthwise conv reshapes {n} tokens onto a {h} x {w} grid "
                                 "(register tokens reach it, as in the JAX package)")
            x = self.dwconv(x.transpose(1, 2).reshape(b, -1, h, w)).flatten(2).transpose(1, 2)
        return self.drop2(self.fc2(self.drop1(nn.functional.gelu(x))))


class ViTBlock(nn.Module):
    """Pre-LN global attention + DWConv feed-forward.  With ``layer_scale`` >
    0 each residual branch is scaled per channel by a learned ``gamma1`` /
    ``gamma2`` that starts at that value; each branch goes through
    DropPath.  ``dw_conv`` False: the feed-forward has no depthwise conv;
    ``drop``: its dropout (``DWConvFFN``)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, drop_path: float = 0.0,
                 layer_scale: float = 0.0, dw_conv: bool = True, drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = layer_norm(dim)
        self.attn_qkv = nn.Linear(dim, 3 * dim)
        self.attn_proj = nn.Linear(dim, dim)
        self.norm2 = layer_norm(dim)
        self.mlp = DWConvFFN(dim, mlp_dim, dim, dw_conv, drop)
        self.drop_path = DropPath(drop_path)
        scaled = layer_scale > 0
        self.gamma1 = nn.Parameter(layer_scale * torch.ones(dim)) if scaled else None
        self.gamma2 = nn.Parameter(layer_scale * torch.ones(dim)) if scaled else None

    def forward(self, x, h: int, w: int):
        b, n, c = x.shape
        hh = self.num_heads
        c_ = c // hh
        qkv = self.attn_qkv(self.norm1(x)).reshape(b, n, 3, hh, c_).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(torch.matmul(qkv[0] * c_ ** -0.5, qkv[1].transpose(-1, -2)), dim=-1)
        branch = self.attn_proj(torch.matmul(attn, qkv[2]).transpose(1, 2).reshape(b, n, c))
        if self.gamma1 is not None:
            branch = self.gamma1 * branch
        x = x + self.drop_path(branch)
        branch = self.mlp(self.norm2(x), h, w)
        if self.gamma2 is not None:
            branch = self.gamma2 * branch
        return x + self.drop_path(branch)


class MixResViT(nn.Module):
    """A global-attention cascade stage, stage 0 as a rule.  forward(im,
    features, features_pos, upsampling_mask, tokens_per_scale, k_split) ->
    (outs, tokens_per_scale) with outs {res{n_scales - scale + 1}: feat,
    _pos: (x, y), _scale, _spatial_shape, min_spatial_shape}.  The first
    stage (``first_layer``) embeds the image; a later one takes the incoming
    stream (LayerNorm, and a Linear from ``in_channels`` where that differs
    from d_model), which must be its full patch grid, and hands its segment
    sizes on.  ``k_split`` is accepted and ignored (this stage splits
    nothing).  ``num_register_tokens``: zero-initialised
    ``register_tokens`` prepended before the blocks and cut off after
    them; ``dropout``: the blocks' feed-forward dropout."""

    def __init__(self, scale: int, n_scales: int, patch_size: int, min_patch_size: int,
                 d_model: int, n_layers: int, n_heads: int, mlp_ratio: float = 4.0,
                 drop_path: Sequence[float] = (), layer_scale: float = 0.0,
                 dropout: float = 0.0, num_register_tokens: int = 0, first_layer: bool = True,
                 in_channels: int = 3):
        super().__init__()
        self.scale, self.n_scales = scale, n_scales
        self.patch_size, self.min_patch_size, self.d_model = patch_size, min_patch_size, d_model
        self.first_layer = first_layer
        if first_layer:
            self.patch_embed = OverlapPatchEmbedding(patch_size, d_model)
        else:
            self.token_norm = layer_norm(in_channels)
            self.token_projection = (nn.Linear(in_channels, d_model) if in_channels != d_model
                                     else None)
        self.register_tokens = (nn.Parameter(torch.zeros(1, num_register_tokens, d_model))
                                if num_register_tokens else None)
        drop_path = tuple(drop_path) or (0.0,) * n_layers
        self.blocks = nn.ModuleList(
            ViTBlock(d_model, n_heads, int(d_model * mlp_ratio), drop_path[i], layer_scale,
                     drop=dropout)
            for i in range(n_layers))
        self.norm_out = layer_norm(d_model)

    def forward(self, im, features=None, features_pos=None, upsampling_mask=None,
                tokens_per_scale=None, k_split=None):
        b, H, W, _ = im.shape
        patched = (H // self.patch_size, W // self.patch_size)
        if self.first_layer:
            x, pos, tokens_per_scale = embed_first_stage(self.patch_embed, im, self.patch_size,
                                                         self.min_patch_size, self.scale)
        else:
            x = self.token_norm(features)
            if self.token_projection is not None:
                x = self.token_projection(x)
            pos = features_pos
        n_reg = 0 if self.register_tokens is None else self.register_tokens.shape[1]
        if n_reg:
            x = torch.cat([self.register_tokens.to(x.dtype).expand(b, -1, -1), x], dim=1)
        for blk in self.blocks:
            x = blk(x, *patched)
        x = x[:, n_reg:]
        return single_scale_outputs(self, self.norm_out(x), pos, patched, H, W), tokens_per_scale


def single_scale_outputs(stage: nn.Module, feat, pos, patched, H: int, W: int) -> Dict:
    """The outputs of a stage whose tokens are one patch grid (its
    ``n_scales``, ``scale`` and ``min_patch_size``): {res{n_scales - scale +
    1}: feat, _pos, _spatial_shape, _scale, min_spatial_shape}."""
    out = f"res{stage.n_scales - stage.scale + 1}"
    return {out: feat, out + "_pos": pos[:, :, 1:], out + "_spatial_shape": patched,
            out + "_scale": pos[:, :, 0],
            "min_spatial_shape": (H // stage.min_patch_size, W // stage.min_patch_size)}


def embed_first_stage(patch_embed: nn.Module, im, patch_size: int, min_patch_size: int,
                      scale: int):
    """A first stage's tokens: the image through ``patch_embed`` plus the
    sine embedding of their positions -> (feat (b, n, c), (scale, x, y) (b,
    n, 3), (n,))."""
    b, H, W, _ = im.shape
    x = patch_embed(im)
    pos_np = get_2dpos_of_curr_ps_in_min_ps(H, W, patch_size, min_patch_size, scale)
    pos = torch.from_numpy(pos_np).to(im.device)[None].expand(b, -1, 3)
    x = x + position_embedding_sine(pos[:, :, 1:], x.shape[-1] // 2).to(x.dtype)
    return x, pos, (pos_np.shape[0],)


class MixResLayer(nn.Module):
    """Cluster-attention blocks over a mixed-scale point cloud: cluster on
    (x, y) along the space-filling curve, find each token's nearest clusters,
    run the blocks, then restore the incoming (scale-segment) token order.
    ``drop`` / ``attn_drop``: the blocks' dropout (``ClusterTransformerBlock``).
    ``cross_attend`` (the XAttn stage): before every block the newest
    segment's tokens, in the incoming order, take a pre-norm cross-attention
    (``x_attn_norm`` / ``x_attn``) to their image patch features, with a
    residual."""

    def __init__(self, dim: int, cluster_size: int, nbhd_size: int, depth: int, num_heads: int,
                 mlp_ratio: float, drop_path: Sequence[float] = (), layer_scale: float = 0.0,
                 drop: float = 0.0, attn_drop: float = 0.0, cross_attend: bool = False):
        super().__init__()
        self.cluster_size, self.nbhd_size = cluster_size, nbhd_size
        drop_path = tuple(drop_path) or (0.0,) * depth
        self.blocks = nn.ModuleList(
            ClusterTransformerBlock(dim, num_heads, mlp_ratio, drop_path[i], layer_scale, drop,
                                    attn_drop)
            for i in range(depth))
        self.x_attn_norm = (nn.ModuleList(layer_norm(dim) for _ in range(depth)) if cross_attend
                            else None)
        self.x_attn = (nn.ModuleList(MultiheadAttention(dim, num_heads) for _ in range(depth))
                       if cross_attend else None)

    def forward(self, pos, feat, h: int, w: int, image_features=None):
        """pos: (b, n, 3) (scale, x, y); feat: (b, n, c) -> feat in the same
        token order.  image_features (b, n_new, c): the memory of the
        cross-attention of the last n_new tokens (``cross_attend``)."""
        b, n, _ = pos.shape
        ctx, _, rank = attention_context(pos[:, :, 1:], b, self.cluster_size, self.nbhd_size,
                                         h, w)
        inv = None
        if rank is not None:
            feat = take_rows(feat, rank)
            inv = torch.empty_like(rank).scatter_(1, rank, torch.arange(n, device=rank.device)
                                                  .expand(b, n))
        for i, blk in enumerate(self.blocks):
            if image_features is not None:
                n_new = image_features.shape[1]
                incoming = feat if inv is None else take_rows(feat, inv)
                new = incoming[:, n - n_new:]
                q = self.x_attn_norm[i](new)
                new = new + self.x_attn[i](q, image_features, image_features)
                incoming = torch.cat([incoming[:, :n - n_new], new], dim=1)
                feat = incoming if rank is None else take_rows(incoming, rank)
            feat = blk(feat, ctx)
        return feat if inv is None else take_rows(feat, inv)


class MixResNeighbour(nn.Module):
    """Cascade stages >= 1: split the newest scale's most disagreed-on tokens
    4 ways, add raw image features to the new tokens, run ``MixResLayer``.
    forward(im, features, features_pos, upsampling_mask, tokens_per_scale,
    k_split) -> (outs, tokens_per_scale), one res{n_scales - s + 1} entry
    per scale segment s.  ``k_split``: the number of tokens to split (at
    most the newest scale's count; int(n * upscale_ratio), at least 1, where
    None).  ``first_layer``: the first stage, which embeds the image
    (overlapping conv patch embedding with BatchNorm, the sine position
    embedding) and splits nothing.  ``cross_attend_image`` (the XAttn
    stage, MixResNeighbourXAttn): the new tokens' image patch features
    (``x_attn_patcher``, a ps x ps conv of stride ps read at each new
    token's cell, plus the sine embedding of its position) are built once
    and cross-attended to before every block (``MixResLayer``)."""

    def __init__(self, scale: int, n_scales: int, patch_sizes: Sequence[int],
                 min_patch_size: int, d_model: int, n_layers: int, n_heads: int,
                 cluster_size: int = 8, nbhd_size: int = 48, mlp_ratio: float = 4.0,
                 split_ratio: int = 4, upscale_ratio: float = 0.25,
                 drop_path: Sequence[float] = (), layer_scale: float = 0.0,
                 in_channels: int = 256, keep_old_scale: bool = True, dropout: float = 0.0,
                 attn_drop: float = 0.0, first_layer: bool = False,
                 cross_attend_image: bool = False):
        super().__init__()
        self.scale, self.n_scales, self.d_model = scale, n_scales, d_model
        self.patch_sizes, self.min_patch_size = tuple(patch_sizes), min_patch_size
        self.split_ratio, self.upscale_ratio = split_ratio, upscale_ratio
        self.keep_old_scale, self.first_layer = keep_old_scale, first_layer
        ps = self.patch_sizes[scale]
        self.x_attn_patcher = None
        if first_layer:
            self.patch_embed = OverlapPatchEmbedding(ps, d_model, use_bn=True)
        else:
            self.rel_pos_emb = nn.Parameter(0.02 * torch.randn(1, 1, split_ratio, in_channels))
            self.scale_emb = nn.Parameter(0.02 * torch.randn(1, 1, 1, in_channels))
            input_dim = max(in_channels, 3 * ps * ps)
            self.image_patch_projection = nn.Linear(3 * ps * ps, input_dim)
            self.high_res_norm1 = layer_norm(input_dim)
            self.high_res_mlp = Mlp(input_dim, in_channels, in_channels)
            self.high_res_norm2 = layer_norm(in_channels)
            self.token_norm = layer_norm(in_channels)
            self.token_projection = (nn.Linear(in_channels, d_model) if in_channels != d_model
                                     else None)
            if cross_attend_image:
                self.x_attn_patcher = nn.Conv2d(3, d_model, ps, stride=ps)
        self.layers = MixResLayer(d_model, cluster_size, nbhd_size, n_layers, n_heads, mlp_ratio,
                                  drop_path, layer_scale, dropout, attn_drop,
                                  cross_attend=self.x_attn_patcher is not None)
        self.norm_out = layer_norm(d_model)

    def _split_tokens(self, feat, pos, scores, k_split: int):
        """The top k_split tokens by score to split (ascending order) and the
        rest to keep; the softmaxed scores ride along as straight-through
        factors (1 in value, their gradient reaches the scores)."""
        n = feat.shape[1]
        order = split_order(scores)
        top, bottom = order[:, n - k_split:], order[:, :n - k_split]
        soft = torch.softmax(scores, dim=1)
        ste = (soft - soft.detach())[..., None]
        return (take_rows(feat * (1.0 + ste), top), take_rows(pos, top),
                take_rows(feat * (1.0 - ste), bottom), take_rows(pos, bottom))

    def _split_pos(self, pos_to_split):
        """(b, k, 3) -> (b, 4k, 3): each token's four children at offsets
        (0, 0), (r, 0), (0, r), (r, r) with r = 2^(n_scales - scale - 1)."""
        r = 2 ** (self.n_scales - self.scale - 1)
        x, y = pos_to_split[:, :, 1], pos_to_split[:, :, 2]
        children = torch.stack([torch.stack([x, y], -1), torch.stack([x + r, y], -1),
                                torch.stack([x, y + r], -1), torch.stack([x + r, y + r], -1)],
                               dim=2)
        b, k = x.shape
        sc = children.new_full((b, 4 * k, 1), float(self.scale))
        return torch.cat([sc, children.reshape(b, 4 * k, 2)], dim=2)

    def _add_high_res_feat(self, tokens, pos_xy, im):
        """Project the raw image patch under each new token (its ps x ps
        pixels, ordered (dy, dx, rgb), clamped into the image) into its
        feature."""
        b, n, _ = pos_xy.shape
        ps = self.patch_sizes[self.scale]
        H, W = im.shape[1:3]
        dy, dx = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
        offs = torch.from_numpy(np.stack([dx.reshape(-1), dy.reshape(-1)], 1).astype(np.float32))
        pp = pos_xy[:, :, None, :] * self.min_patch_size + offs.to(im.device)   # (b, n, ps^2, 2)
        xg = torch.clamp(pp[..., 0].long(), 0, W - 1)
        yg = torch.clamp(pp[..., 1].long(), 0, H - 1)
        vals = take_rows(im.reshape(b, H * W, 3), (yg * W + xg).reshape(b, -1))
        y = nn.functional.gelu(self.image_patch_projection(vals.reshape(b, n, ps * ps * 3)))
        return tokens + self.high_res_norm2(self.high_res_mlp(self.high_res_norm1(y)))

    def _image_patch_features(self, pos_xy, im):
        """The XAttn memory: ``x_attn_patcher``'s feature of the ps x ps cell
        under each token (b, n, 2) -> (b, n, d_model)."""
        step = self.patch_sizes[self.scale] // self.min_patch_size
        patched = self.x_attn_patcher(im.permute(0, 3, 1, 2))               # (b, c, h, w)
        h, w = patched.shape[2:]
        cx = torch.clamp((pos_xy[..., 0] / step).long(), 0, w - 1)
        cy = torch.clamp((pos_xy[..., 1] / step).long(), 0, h - 1)
        return take_rows(patched.flatten(2).transpose(1, 2), cy * w + cx)

    def forward(self, im, features, features_pos, upsampling_mask, tokens_per_scale,
                k_split=None):
        b, H, W, _ = im.shape
        min_patched = (H // self.min_patch_size, W // self.min_patch_size)
        if self.first_layer:
            x, pos, tps = embed_first_stage(self.patch_embed, im, self.patch_sizes[self.scale],
                                            self.min_patch_size, self.scale)
            return self._outputs(self.norm_out(self.layers(pos, x, *min_patched)), pos, tps,
                                 H, W)
        n_curr = tokens_per_scale[-1]
        n_old = sum(tokens_per_scale[:-1])
        # the disagreement covers the whole stream (the MaskFiner decoder's)
        # or only the newest scale
        scores = upsampling_mask if upsampling_mask.shape[1] == n_curr \
            else upsampling_mask[:, n_old:]
        if k_split is None:
            k_split = max(1, int(n_curr * self.upscale_ratio))
        k_split = min(k_split, n_curr)
        tok_split, pos_split, tok_keep, pos_keep = self._split_tokens(
            features[:, n_old:], features_pos[:, n_old:], scores, k_split)

        up_feat = tok_split[:, :, None, :] + self.rel_pos_emb + self.scale_emb
        up_feat = up_feat.reshape(b, k_split * self.split_ratio, -1)
        up_pos = self._split_pos(pos_split)
        up_feat = self._add_high_res_feat(up_feat, up_pos[:, :, 1:], im)

        feat_old, pos_old = features[:, :n_old], features_pos[:, :n_old]
        if self.keep_old_scale:
            x = torch.cat([feat_old, tok_keep, tok_split, up_feat], dim=1)
            pos = torch.cat([pos_old, pos_keep, pos_split, up_pos], dim=1)
            tps = tuple(tokens_per_scale[:-1]) + (n_curr, k_split * self.split_ratio)
        else:
            x = torch.cat([feat_old, tok_keep, up_feat], dim=1)
            pos = torch.cat([pos_old, pos_keep, up_pos], dim=1)
            tps = tuple(tokens_per_scale[:-1]) + (n_curr - k_split, k_split * self.split_ratio)
        x = self.token_norm(x)
        if self.token_projection is not None:
            x = self.token_projection(x)
        image_features = None
        if self.x_attn_patcher is not None:
            new_xy = pos[:, pos.shape[1] - tps[-1]:, 1:]
            image_features = self._image_patch_features(new_xy, im)
            image_features = image_features + position_embedding_sine(
                new_xy, self.d_model // 2).to(image_features.dtype)
        x = self.norm_out(self.layers(pos, x, *min_patched, image_features))
        return self._outputs(x, pos, tps, H, W)

    def _outputs(self, x, pos, tps, H: int, W: int) -> Dict:
        outs: Dict = {"min_spatial_shape": (H // self.min_patch_size, W // self.min_patch_size)}
        start = 0
        for s, cnt in enumerate(tps):
            out = f"res{self.n_scales - s + 1}"
            outs[out] = x[:, start:start + cnt]
            outs[out + "_pos"] = pos[:, start:start + cnt, 1:]
            outs[out + "_scale"] = pos[:, start:start + cnt, 0]
            outs[out + "_spatial_shape"] = (H // self.patch_sizes[s], W // self.patch_sizes[s])
            start += cnt
        return outs, tps
