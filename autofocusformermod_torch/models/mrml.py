"""The MixRes MetaLoss (MRML) family: one backbone that splits its own
tokens by a learned per-token "meta loss" (the error it predicts at the
token's patch), and the MaskFormer over it whose training adds that
prediction's L1 against the segmentation's real error.

Counterpart of ``autofocusformermod_tpu/models/mrml.py``:

- ``MixResMetaLoss``: a patch embedding, then per scale a stack of blocks
  over the mixed-scale stream (``ViTBlock`` without the depthwise conv, or
  with ``use_cluster_attention`` the cluster attention of
  ``mixres.MixResLayer``: the ``local_attn`` kernel on CUDA), after which
  the newest scale's tokens with the highest predicted meta loss (the
  ``metalosses_{l}`` head on detached features; with
  ``mean_activation_scores`` their mean absolute activation) are split 4
  ways by a learned Linear, read their image cell from a strided conv, and
  the whole stream is projected to the next scale's width;
- ``MaskFormerML``: that backbone under the MaskFormer head, its per-scale
  predictions returned as ``metaloss_preds`` / ``metaloss_pos``;
- ``compute_meta_loss`` / ``metaloss_l1``: the meta loss's target and its
  L1.

Unlike ``mixres.MixResNeighbour`` the split token's parent is dropped, the
kept tokens come in ascending and the split ones in descending score
order (two top-k, ties to the lower index, as jax.lax.top_k), and the split
has no straight-through gradient.  The global attention of the plain
variant is a plain matrix product, as in the JAX package (an einsum there,
outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..ops.gather import take_rows, topk_indices
from ..parallel.precision import compute_dtype, f32_outputs, refuse_islands
from .layers import Mlp, layer_norm, position_embedding_sine
from .maskformer import MaskFormer, MaskFormerHead
from .mixres import MixResLayer, OverlapPatchEmbedding, ViTBlock, get_2dpos_of_curr_ps_in_min_ps

# MODEL.BACKBONE.NAME -> (use_cluster_attention, mean_activation_scores)
MRML_BACKBONES = {"MixResMetaLoss": (False, False), "MixResMeanAct": (False, True),
                  "MixResMetaLossNeighbour": (True, False)}
# the cluster attention's clusters and neighbourhoods (tokens): the JAX
# package's MixResMetaLoss defaults, which no config sets
CLUSTER_SIZE, NBHD_SIZE = 8, 48


class GlobalBlocks(nn.Module):
    """One scale's global-attention blocks (no depthwise conv, so the
    canvas (h, w) is not read)."""

    def __init__(self, dim: int, depth: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(ViTBlock(dim, num_heads, int(dim * mlp_ratio), dw_conv=False)
                                    for _ in range(depth))

    def forward(self, pos, x, h: int, w: int):
        for blk in self.blocks:
            x = blk(x, h, w)
        return x


class MixResMetaLoss(nn.Module):
    """forward(normalised NHWC image) -> {res{n_scales - s + 1} (b, n_s, c)
    for each scale s's segment, its ``_pos`` (the tokens' cells on the
    scale's own grid), ``_scale`` and ``_spatial_shape``, ``metaloss{l}``
    (b, n) each split scale's predicted meta loss over its newest segment
    and ``metaloss{l}_pos`` (b, n, 2) those tokens' positions on the
    min-patch canvas, ``min_spatial_shape``}.  Every output has the last
    scale's width."""

    def __init__(self, n_scales: int = 4, patch_sizes: Sequence[int] = (32, 16, 8, 4),
                 embed_dims: Sequence[int] = (512, 256, 128, 64),
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (32, 16, 8, 4),
                 mlp_ratio: float = 4.0, split_ratio: int = 4, upscale_ratio: float = 0.25,
                 use_cluster_attention: bool = False, mean_activation_scores: bool = False):
        super().__init__()
        self.n_scales, self.patch_sizes = n_scales, tuple(patch_sizes)
        self.embed_dims, self.split_ratio = tuple(embed_dims), split_ratio
        self.upscale_ratio = upscale_ratio
        self.mean_activation_scores = mean_activation_scores
        self.patch_embed = OverlapPatchEmbedding(self.patch_sizes[0], self.embed_dims[0])
        if use_cluster_attention:
            self.layers = nn.ModuleList(
                MixResLayer(embed_dims[l], CLUSTER_SIZE, NBHD_SIZE, depths[l], num_heads[l],
                            mlp_ratio) for l in range(n_scales))
        else:
            self.layers = nn.ModuleList(GlobalBlocks(embed_dims[l], depths[l], num_heads[l],
                                                     mlp_ratio) for l in range(n_scales))
        splits = range(n_scales - 1)
        dims = [embed_dims[l] for l in splits]
        self.metalosses = (None if mean_activation_scores
                           else nn.ModuleList(Mlp(d, d, 1) for d in dims))
        self.splits = nn.ModuleList(nn.Linear(d, split_ratio * d) for d in dims)
        for l, d in zip(splits, dims):
            # bare parameters, under the JAX package's names
            setattr(self, f"rel_pos_embs_{l}",
                    nn.Parameter(0.02 * torch.randn(1, 1, split_ratio, d)))
            setattr(self, f"scale_embs_{l}", nn.Parameter(0.02 * torch.randn(1, 1, 1, d)))
        self.high_res_patchers = nn.ModuleList(
            nn.Conv2d(3, d, self.patch_sizes[l + 1], stride=self.patch_sizes[l + 1])
            for l, d in zip(splits, dims))
        self.downsamplers_norm = nn.ModuleList(layer_norm(d) for d in dims)
        self.downsamplers = nn.ModuleList(nn.Linear(embed_dims[l], embed_dims[l + 1])
                                          for l in splits)

    def scores(self, l: int, feat: torch.Tensor) -> torch.Tensor:
        """Scale l's split scores of its newest tokens (b, n, c) -> (b, n):
        the predicted meta loss, or the mean absolute activation; no
        gradient reaches the features."""
        if self.mean_activation_scores:
            return feat.detach().abs().mean(dim=-1)
        return self.metalosses[l](feat.detach())[..., 0]

    def _children(self, l: int, split_f, split_p, im):
        """The split tokens' children: (features (b, 4k, c), positions (b, 4k,
        3)) -- a Linear to 4 features each, the learned offsets, and the
        strided conv of the image read at each child's cell."""
        b, k, dim = split_f.shape
        sf = self.splits[l](split_f).reshape(b, k, self.split_ratio, dim)
        sf = (sf + getattr(self, f"rel_pos_embs_{l}") + getattr(self, f"scale_embs_{l}"))
        sf = sf.reshape(b, k * self.split_ratio, dim)
        new_scale = l + 1
        r = 2 ** (self.n_scales - new_scale - 1)
        x, y = split_p[:, :, 1], split_p[:, :, 2]
        children = torch.stack([torch.stack([x, y], -1), torch.stack([x + r, y], -1),
                                torch.stack([x, y + r], -1), torch.stack([x + r, y + r], -1)],
                               dim=2).reshape(b, k * 4, 2)
        sp = torch.cat([children.new_full((b, k * 4, 1), float(new_scale)), children], dim=2)
        patched = self.high_res_patchers[l](im.permute(0, 3, 1, 2))     # (b, dim, hh, ww)
        hh, ww = patched.shape[2:]
        cx = (children[..., 0] / r).long().clamp(0, ww - 1)
        cy = (children[..., 1] / r).long().clamp(0, hh - 1)
        sf = sf + take_rows(patched.flatten(2).transpose(1, 2), cy * ww + cx)
        return sf, sp

    def forward(self, im: torch.Tensor) -> Dict:
        b, H, W, _ = im.shape
        min_ps = self.patch_sizes[self.n_scales - 1]
        min_patched = (H // min_ps, W // min_ps)
        x = self.patch_embed(im)
        pos_np = get_2dpos_of_curr_ps_in_min_ps(H, W, self.patch_sizes[0], min_ps, 0)
        pos = torch.from_numpy(pos_np).to(im.device)[None].expand(b, -1, 3)
        x = x + position_embedding_sine(pos[:, :, 1:], self.embed_dims[0] // 2).to(x.dtype)
        tokens_per_scale = (pos_np.shape[0],)

        outs: Dict = {"min_spatial_shape": min_patched}
        for l in range(self.n_scales):
            ps = self.patch_sizes[l]
            x = self.layers[l](pos, x, *min_patched)
            outs[f"res{self.n_scales - l + 1}_spatial_shape"] = (H // ps, W // ps)
            if l == self.n_scales - 1:
                break
            # split the newest scale's tokens with the highest scores
            n_curr = tokens_per_scale[-1]
            n_old = sum(tokens_per_scale[:-1])
            feat_c, pos_c = x[:, n_old:], pos[:, n_old:]
            pred_ml = self.scores(l, feat_c)
            outs[f"metaloss{l}"] = pred_ml
            outs[f"metaloss{l}_pos"] = pos_c[:, :, 1:]
            k_split = max(1, int(n_curr * self.upscale_ratio))
            top = topk_indices(pred_ml, k_split)
            bot = topk_indices(-pred_ml, n_curr - k_split)
            sf, sp = self._children(l, take_rows(feat_c, top), take_rows(pos_c, top), im)
            x = torch.cat([x[:, :n_old], take_rows(feat_c, bot), sf], dim=1)
            pos = torch.cat([pos[:, :n_old], take_rows(pos_c, bot), sp], dim=1)
            tokens_per_scale = tokens_per_scale[:-1] + (n_curr - k_split, sf.shape[1])
            x = self.downsamplers[l](self.downsamplers_norm[l](x))

        start = 0
        for s, cnt in enumerate(tokens_per_scale):
            out = f"res{self.n_scales - s + 1}"
            seg = pos[:, start:start + cnt]
            outs[out] = x[:, start:start + cnt]
            outs[out + "_pos"] = torch.floor(seg[:, :, 1:] / 2 ** (self.n_scales - s - 1))
            outs[out + "_scale"] = seg[:, :, 0]
            start += cnt
        return outs


def mixres_metaloss_from_config(cfg, name: str = "MixResMetaLoss") -> MixResMetaLoss:
    """The MRML backbone ``name`` (one of ``MRML_BACKBONES``) from
    MODEL.MRML: the fields the JAX package reads (DROP_PATH_RATE,
    CLUSTER_SIZE and NBHD_SIZE are not read: no DropPath, the module's
    CLUSTER_SIZE and NBHD_SIZE)."""
    mrml = cfg.MODEL.MRML
    cluster, mean_act = MRML_BACKBONES[name]
    return MixResMetaLoss(
        n_scales=mrml.NUM_SCALES, patch_sizes=tuple(mrml.PATCH_SIZES),
        embed_dims=tuple(mrml.EMBED_DIM), depths=tuple(mrml.DEPTHS),
        num_heads=tuple(mrml.NUM_HEADS), mlp_ratio=mrml.MLP_RATIO, split_ratio=mrml.SPLIT_RATIO,
        upscale_ratio=mrml.UPSCALE_RATIO, use_cluster_attention=cluster,
        mean_activation_scores=mean_act)


def mrml_feature_channels(cfg) -> Dict[str, int]:
    """Every MRML output has the last scale's width."""
    return {f"res{i + 2}": int(cfg.MODEL.MRML.EMBED_DIM[-1]) for i in range(4)}


class MaskFormerML(MaskFormer):
    """forward(raw NHWC RGB images) -> MaskFormer's outputs plus
    'metaloss_preds' (each split scale's (b, n) predicted meta loss) and
    'metaloss_pos' (their (b, n, 2) positions on the min-patch canvas)."""

    def forward(self, images: torch.Tensor) -> Dict:
        feats = self.backbone(self.normalize(images).to(self.compute_dtype))
        out = self.sem_seg_head(feats)
        n = self.backbone.n_scales - 1
        out["metaloss_preds"] = tuple(feats[f"metaloss{i}"] for i in range(n))
        out["metaloss_pos"] = tuple(feats[f"metaloss{i}_pos"] for i in range(n))
        return out if self.compute_dtype == torch.float32 else f32_outputs(out)


def maskformer_ml_from_config(cfg) -> MaskFormerML:
    """MaskFormerML: the MRML backbone that MODEL.BACKBONE.NAME names
    (MixResMetaLoss for a name outside the family, so the bare
    ``maskformer2_ml_R50`` yaml gets the MRML defaults), the point-cloud
    pixel decoder -- its ``MSDeformAttnPixelDecoderUp`` form (mask features
    on the full finest grid) where SEM_SEG_HEAD.PIXEL_DECODER_NAME says so
    -- and the masked decoder; the head is built first, as
    ``maskformer_from_config`` builds it.  SOLVER.AMP.ENABLED: bf16
    compute, fp32 outputs (no fp32 island)."""
    from .pixel_decoder import pixel_decoder_from_config
    from .transformer_decoder import transformer_decoder_from_config

    name = cfg.MODEL.BACKBONE.NAME
    up = cfg.MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME == "MSDeformAttnPixelDecoderUp"
    head = MaskFormerHead(pixel_decoder_from_config(cfg, mrml_feature_channels(cfg), up),
                          transformer_decoder_from_config(cfg, cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM))
    backbone = mixres_metaloss_from_config(cfg, name if name in MRML_BACKBONES
                                           else "MixResMetaLoss")
    refuse_islands(cfg, "MaskFormerML")
    return MaskFormerML(backbone, head, tuple(cfg.MODEL.PIXEL_MEAN), tuple(cfg.MODEL.PIXEL_STD),
                        compute_dtype(cfg))


def metaloss_l1(pred_metaloss: torch.Tensor, pos_xy: torch.Tensor, error_map: torch.Tensor,
                patch_size_in_min_units: int) -> torch.Tensor:
    """The mean L1 between each token's predicted meta loss (b, n) and the
    mean of ``error_map`` (b, Hm, Wm) over its patch: the p x p min patches
    (p = ``patch_size_in_min_units``) from its position (b, n, 2) on, clipped
    to the map, by box sums of an integral image; no gradient to the
    target."""
    b, Hm, Wm = error_map.shape
    ii = nn.functional.pad(error_map.cumsum(1).cumsum(2), (1, 0, 1, 0)).reshape(b, -1)
    p = patch_size_in_min_units
    x0 = pos_xy[..., 0].long().clamp(0, Wm)
    y0 = pos_xy[..., 1].long().clamp(0, Hm)
    x1, y1 = (x0 + p).clamp(0, Wm), (y0 + p).clamp(0, Hm)

    def at(y, x):
        return torch.gather(ii, 1, y * (Wm + 1) + x)

    sums = at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)
    actual = sums / torch.clamp((x1 - x0) * (y1 - y0), min=1).float()
    return (pred_metaloss - actual.detach()).abs().mean()


def compute_meta_loss(outputs: Dict, tgt_labels: torch.Tensor, tgt_masks: torch.Tensor,
                      tgt_valid: torch.Tensor, min_patch_size: int) -> torch.Tensor:
    """The meta loss: the label map composed from the valid target masks
    (b, t, H, W) times their labels (b, t) (clamped below the class count;
    pixels no mask covers are class 0), the per-pixel cross-entropy of the
    detached soft semantic map (the mask logits resized bilinearly to H x W,
    half-pixel centres) against it, averaged over each min patch, and each
    split scale's ``metaloss_l1`` against that map; the mean over
    scales."""
    preds, poss = outputs["metaloss_preds"], outputs["metaloss_pos"]
    n_scales = len(preds) + 1
    H, W = tgt_masks.shape[-2:]
    v = tgt_valid.float()
    label_map = torch.einsum("bqhw,bq->bhw", tgt_masks * v[:, :, None, None],
                             tgt_labels.float() * v).long()
    nc = outputs["pred_logits"].shape[-1] - 1
    label_map = label_map.clamp(0, nc - 1)
    mask_cls = outputs["pred_logits"].detach()
    mask_pred = nn.functional.interpolate(outputs["pred_masks"].detach(), size=(H, W),
                                          mode="bilinear", align_corners=False)
    cls = torch.softmax(mask_cls, dim=-1)[..., :-1]
    semseg = torch.einsum("bqc,bqhw->bchw", cls, torch.sigmoid(mask_pred))
    logp = torch.log_softmax(semseg, dim=1)
    ce = -torch.gather(logp, 1, label_map[:, None])[:, 0]                 # (b, H, W)
    b, p = ce.shape[0], min_patch_size
    emap = ce.reshape(b, H // p, p, W // p, p).mean(dim=(2, 4))
    losses = [metaloss_l1(pred, pos, emap, 2 ** (n_scales - 1 - i))
              for i, (pred, pos) in enumerate(zip(preds, poss))]
    return torch.stack(losses).mean()
