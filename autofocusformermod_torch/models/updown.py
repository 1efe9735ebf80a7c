"""UpDownBackbone: the composite MixRes backbone of the OracleTeacher-BB
cascades.

Counterpart of ``autofocusformermod_tpu/models/updown.py``.  A chain of
2n - 1 MixRes stages runs the scales 0 .. n-1 .. 0 of an n-scale model:

- the down pass is a MixResViT (stage 0) and n - 1 MixResNeighbour stages
  (whatever MR.NAME calls them: the JAX package builds these),
  each splitting the tokens of the newest scale that its predecessor's
  upsampling head (``MLPDeepNorm``, over the newest scale's tokens only)
  scores highest; in training with ground truth the head's score may be
  replaced by the GT-edge oracle's (``models/oracle.py``), and the pairs of
  score and oracle are returned for the upsampling loss;
- the up pass (n - 1 stages, ``MixResLayer``: global attention where the
  stage is named MixResViT, else cluster attention, whatever the name, as
  in the JAX package) re-processes ever shorter
  prefixes of the token stream, one scale segment fewer each stage, with
  the mirrored down stage's stream concatenated channel-wise (LayerNorm +
  Linear); each stage's finest remaining segment is that resolution's
  output.

``down_only`` gives the OracleTeacherBackbone: the n down stages alone,
every resolution read from the last stage's stream.  Each resolution's
positions, scales and grid shape are those of the stage that first emitted
it, as in the JAX package (a later stage that splits the resolution's
tokens reorders its segment, not those positions).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .layers import layer_norm
from .mixres import MixResLayer, MixResNeighbour, MixResViT
from .oracle import gt_edge_map, mix_teacher_mask, oracle_upsampling_mask


class MLPDeepNorm(nn.Module):
    """``num_layers`` x (Linear -> exact GELU -> LayerNorm): ``hidden`` wide,
    the last ``out`` wide."""

    def __init__(self, in_dim: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(
            nn.ModuleDict({"linear": nn.Linear(a, d), "norm": layer_norm(d)})
            for a, d in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers:
            x = layer["norm"](nn.functional.gelu(layer["linear"](x)))
        return x


class UpDownBackbone(nn.Module):
    """forward(normalised NHWC images, sem_seg_gt=None) -> {res{k}: (b, n_k,
    c_k), res{k}_pos / _scale / _spatial_shape, min_spatial_shape,
    upsampling_mask_pred_{s} (b, n_new) and upsampling_mask_pos_{s} for each
    down stage s < n - 1, and upsampling_mask_oracle_{s} where
    ``sem_seg_gt`` (b, H, W) is given}.  Every per-stage sequence has 2n - 1
    entries (n with ``down_only``)."""

    def __init__(self, n_scales: int, names: Sequence[str], patch_sizes: Sequence[int],
                 embed_dims: Sequence[int], depths: Sequence[int], num_heads: Sequence[int],
                 mlp_ratios: Sequence[float], cluster_sizes: Sequence[int],
                 nbhd_sizes: Sequence[int], upscale_ratios: Sequence[float],
                 split_ratios: Sequence[int], drop_path_rate: float = 0.0,
                 layer_scale: float = 0.0, keep_old_scale: bool = True,
                 oracle_ratio: float = 0.0, ignore_label: int = 255, down_only: bool = False,
                 drop_rates: Sequence[float] = (), attn_drop_rates: Sequence[float] = (),
                 num_register_tokens: int = 0):
        super().__init__()
        n = n_scales
        n_stages = n if down_only else 2 * n - 1
        drop_rates = tuple(drop_rates) or (0.0,) * n_stages
        attn_drop_rates = tuple(attn_drop_rates) or (0.0,) * n_stages
        kind = "OracleTeacherBackbone" if down_only else "UpDownBackbone"
        if len(names) != n_stages:
            raise ValueError(f"{kind} needs {n_stages} per-stage entries, got {len(names)}")
        # as in the JAX package, the names past stage 0 choose only an up
        # stage's attention: every later down stage is a MixResNeighbour
        if names[0] != "MixResViT":
            raise ValueError(f"{kind}'s first stage must be MixResViT, got {names[0]!r}")
        if not keep_old_scale:
            raise ValueError(f"{kind} needs KEEP_OLD_SCALE: the mirrored residual concat relies "
                             "on each scale segment keeping its tokens")
        self.n_scales, self.down_only, self.patch_sizes = n, down_only, tuple(patch_sizes)
        self.oracle_ratio, self.ignore_label = oracle_ratio, ignore_label
        self.oracle_generator: Optional[torch.Generator] = None
        min_ps = patch_sizes[n - 1]
        # one DropPath ramp over every stage's blocks
        dpr = np.linspace(0, drop_path_rate, sum(depths))

        def stage_drop_path(t):
            lo = sum(depths[:t])
            return tuple(float(d) for d in dpr[lo:lo + depths[t]])

        self.backbones = nn.ModuleList([MixResViT(
            scale=0, n_scales=n, patch_size=patch_sizes[0], min_patch_size=min_ps,
            d_model=embed_dims[0], n_layers=depths[0], n_heads=num_heads[0],
            mlp_ratio=mlp_ratios[0], drop_path=stage_drop_path(0), layer_scale=layer_scale,
            dropout=drop_rates[0], num_register_tokens=num_register_tokens)])
        for s in range(1, n):
            self.backbones.append(MixResNeighbour(
                scale=s, n_scales=n, patch_sizes=tuple(patch_sizes[:s + 1]),
                min_patch_size=min_ps, d_model=embed_dims[s], n_layers=depths[s],
                n_heads=num_heads[s], cluster_size=cluster_sizes[s], nbhd_size=nbhd_sizes[s],
                mlp_ratio=mlp_ratios[s], split_ratio=split_ratios[s],
                upscale_ratio=upscale_ratios[s], drop_path=stage_drop_path(s),
                layer_scale=layer_scale, in_channels=embed_dims[s - 1], keep_old_scale=True,
                dropout=drop_rates[s], attn_drop=attn_drop_rates[s]))
        self.upsamplers = nn.ModuleList(MLPDeepNorm(embed_dims[s], embed_dims[s], 1)
                                        for s in range(n - 1))
        self.up_token_norm, self.up_token_projection = nn.ModuleList(), nn.ModuleList()
        for j in range(0 if down_only else n - 1):
            t, mirror = n + j, n - 2 - j
            self.up_token_norm.append(layer_norm(embed_dims[t - 1] + embed_dims[mirror]))
            self.up_token_projection.append(nn.Linear(embed_dims[t - 1] + embed_dims[mirror],
                                                      embed_dims[t]))
            # a MixResViT up stage attends globally: every token is in every
            # token's neighbourhood
            nbhd = math.inf if names[t] == "MixResViT" else nbhd_sizes[t]
            self.backbones.append(MixResLayer(embed_dims[t], cluster_sizes[t], nbhd, depths[t],
                                              num_heads[t], mlp_ratios[t], stage_drop_path(t),
                                              layer_scale, drop_rates[t], attn_drop_rates[t]))
        # each resolution's width: the last stage that emits it
        self.out_channels = {f"res{n - t + 1}": embed_dims[n - 1] for t in range(n)}
        if not down_only:
            self.out_channels.update({f"res{j + 3}": embed_dims[n + j] for j in range(n - 1)})

    def _stream(self, feats: Dict, tokens_per_scale, outs: Dict):
        """A stage's scale segments as one token stream (b, n, c) and its
        (scale, x, y) (b, n, 3); each resolution's positions, scales and grid
        shape recorded in ``outs`` where they are not yet."""
        n = self.n_scales
        seg_feats, seg_pos, seg_scale = [], [], []
        for t in range(len(tokens_per_scale)):
            f = f"res{n - t + 1}"
            seg_feats.append(feats[f])
            seg_pos.append(feats[f + "_pos"])
            seg_scale.append(feats[f + "_scale"])
            if f + "_pos" not in outs:
                for key in ("_pos", "_scale", "_spatial_shape"):
                    outs[f + key] = feats[f + key]
        pos3 = torch.cat([torch.cat(seg_scale, dim=1)[..., None], torch.cat(seg_pos, dim=1)],
                         dim=2)
        return torch.cat(seg_feats, dim=1), pos3

    def forward(self, im: torch.Tensor, sem_seg_gt: Optional[torch.Tensor] = None) -> Dict:
        n = self.n_scales
        _, H, W, _ = im.shape
        min_ps = self.patch_sizes[n - 1]
        min_patched = (H // min_ps, W // min_ps)
        outs: Dict = {"min_spatial_shape": min_patched}
        edges = gt_edge_map(sem_seg_gt, self.ignore_label) if sem_seg_gt is not None else None

        # the down pass: split scale by scale
        features = pos3 = upsampling_mask = None
        tokens_per_scale: Tuple[int, ...] = ()
        down_streams, down_tps = [], []
        for s in range(n):
            stage = self.backbones[s]
            feats, tokens_per_scale = (stage(im) if s == 0 else
                                       stage(im, features, pos3, upsampling_mask, tokens_per_scale))
            features, pos3 = self._stream(feats, tokens_per_scale, outs)
            down_streams.append(features)
            down_tps.append(tuple(tokens_per_scale))
            if s == n - 1:
                break
            # the upsampling score over the newest scale's tokens only
            n_new = tokens_per_scale[-1]
            pred = self.upsamplers[s](features[:, -n_new:])[..., 0]
            outs[f"upsampling_mask_pred_{s}"] = pred
            outs[f"upsampling_mask_pos_{s}"] = pos3[:, -n_new:]
            upsampling_mask = pred
            if edges is not None:
                oracle = oracle_upsampling_mask(edges, pos3[:, -n_new:, 1:], pos3[:, -n_new:, 0],
                                                self.patch_sizes[:n], min_ps)
                outs[f"upsampling_mask_oracle_{s}"] = oracle
                if self.training:
                    upsampling_mask = mix_teacher_mask(self.oracle_generator, pred, oracle,
                                                       self.oracle_ratio)

        if self.down_only:
            start = 0
            for t, cnt in enumerate(tokens_per_scale):
                outs[f"res{n - t + 1}"] = features[:, start:start + cnt]
                start += cnt
            return outs

        # the finest resolution is final after the last down stage
        outs["res2"] = features[:, -tokens_per_scale[-1]:]
        # the up pass: ever shorter prefixes, the mirrored down stream concatenated
        x, p, tps = features, pos3, list(tokens_per_scale)
        for j in range(n - 1):
            t, mirror, m_seg = n + j, n - 2 - j, n - 1 - j
            keep_n = sum(tps[:m_seg])
            x, p, tps = x[:, :keep_n], p[:, :keep_n], tps[:m_seg]
            if down_tps[mirror] != tuple(tps):
                raise AssertionError(f"up stage {t}: mirrored down stage {mirror} segment sizes "
                                     f"{down_tps[mirror]} != current {tuple(tps)}")
            x = torch.cat([x, down_streams[mirror]], dim=2)
            x = self.up_token_projection[j](self.up_token_norm[j](x))
            x = self.backbones[t](p, x, *min_patched)
            # the finest remaining segment is final after this stage
            outs[f"res{j + 3}"] = x[:, -tps[-1]:]
        return outs


def updown_from_config(cfg, down_only: bool = False) -> UpDownBackbone:
    """UpDownBackbone from MODEL.MR's 2n - 1-entry lists (n =
    MASK_FINER.NUM_RESOLUTION_SCALES); ``down_only`` gives the
    OracleTeacherBackbone from n-entry lists.  A list-valued DROP_PATH_RATE
    is read as its largest entry, the end of the one ramp."""
    mr = cfg.MODEL.MR
    rate = mr.DROP_PATH_RATE
    return UpDownBackbone(
        n_scales=cfg.MODEL.MASK_FINER.NUM_RESOLUTION_SCALES, names=tuple(mr.NAME),
        patch_sizes=tuple(mr.PATCH_SIZES), embed_dims=tuple(mr.EMBED_DIM),
        depths=tuple(mr.DEPTHS), num_heads=tuple(mr.NUM_HEADS), mlp_ratios=tuple(mr.MLP_RATIO),
        cluster_sizes=tuple(mr.CLUSTER_SIZE), nbhd_sizes=tuple(mr.NBHD_SIZE),
        upscale_ratios=tuple(mr.UPSCALE_RATIO), split_ratios=tuple(mr.SPLIT_RATIO),
        drop_path_rate=(max(float(r) for r in rate) if isinstance(rate, (list, tuple))
                        else float(rate)),
        layer_scale=mr.LAYER_SCALE, keep_old_scale=mr.KEEP_OLD_SCALE,
        oracle_ratio=cfg.MODEL.MASK_FINER.ORACLE_TEACHER_RATIO,
        ignore_label=cfg.MODEL.MR_SEM_SEG_HEAD.IGNORE_VALUE, down_only=down_only,
        drop_rates=tuple(mr.DROP_RATE), attn_drop_rates=tuple(mr.ATTN_DROP_RATE),
        num_register_tokens=mr.NUM_REGISTER_TOKENS)
