"""The weights bridges: the JAX package's parameter tree -> this port's state
dict, and a reference checkpoint file -> the port's model.

``flax_to_torch_state_dict`` is the inverse of
``autofocusformermod_tpu/engine/convert_checkpoint.py:
convert_reference_state_dict``.  The port's parameter names are the
reference PyTorch state-dict names, so the JAX-trained (or JAX-initialized)
weights load into the port and the two can be compared on the same inputs.
Numpy only on the way in (no flax needed); tensors come out.

``load_reference_weights`` is the counterpart of the same module's
``load_torch_state_dict`` + ``_strip_prefix`` + ``load_reference_weights``:
a reference ``.pth`` or detectron2 ``.pkl`` (for one the backbone-only
``aff_mini.pth`` that the yamls name as ``MODEL.WEIGHTS``) merged by name
into the model, no renaming needed.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# flax module path (dotted) -> reference name, applied in order
_RULES = (
    (r"^mask_predictors_(\d+)", r"mask_predictors.\1"),
    # the UpDownBackbone's stages, upsampling heads and up-pass projections
    (r"^backbone\.(backbones|upsamplers|up_token_norm|up_token_projection)_(\d+)",
     r"backbone.\1.\2"),
    (r"\.upsamplers\.(\d+)\.layers_(\d+)_(linear|norm)$", r".upsamplers.\1.layers.\2.\3"),
    # the MRML backbone's per-scale heads, splits, image patchers and projections
    (r"^backbone\.(metalosses|splits|high_res_patchers|downsamplers_norm|downsamplers)_(\d+)",
     r"backbone.\1.\2"),
    # the OracleTeacher stages' score MLP
    (r"\.upsample_out\.layers_(\d+)", r".upsample_out.layers.\1"),
    # the XAttn stages' per-block cross-attention and the ConvNeXtV2 stages' blocks
    (r"\.x_attn_norm_(\d+)", r".x_attn_norm.\1"),
    (r"\.x_attn_(\d+)", r".x_attn.\1"),
    (r"\.stage_(\d+)", r".stage.\1"),
    # the R50 (detectron2 names)
    (r"^backbone\.stem_conv1", r"backbone.stem.conv1"),
    (r"^backbone\.res(\d)_(\d+)", r"backbone.res\1.\2"),
    (r"\.(conv\d|shortcut)_norm$", r".\1.norm"),
    # Swin
    (r"^backbone\.patch_embed_(proj|norm)$", r"backbone.patch_embed.\1"),
    (r"^backbone\.layers_(\d+)_blocks_(\d+)", r"backbone.layers.\1.blocks.\2"),
    (r"^backbone\.layers_(\d+)_downsample", r"backbone.layers.\1.downsample"),
    (r"^backbone\.layers_(\d+)", r"backbone.layers.\1"),
    (r"\.blocks_(\d+)", r".blocks.\1"),
    (r"\.conv_(\d+)\.", r".conv.\1."),
    (r"\.weight_net\.linear", r".weight_net.0"),
    (r"\.weight_net\.norm", r".weight_net.1"),
    (r"^head\.pixel_decoder", r"sem_seg_head.pixel_decoder"),
    (r"\.input_proj_(\d+)_(dense|conv)", r".input_proj.\1.0"),
    (r"\.input_proj_(\d+)_norm", r".input_proj.\1.1"),
    (r"\.encoder_layer_(\d+)_", r".transformer.encoder.layers.\1."),
    (r"\.encoder_layer_(\d+)", r".transformer.encoder.layers.\1"),
    # the grid pixel decoder's FPN convolutions (their norms: _GRID_RULES)
    (r"\.(adapter|layer)_(\d+)_conv$", r".\1_\2"),
    (r"\.adapter_(\d+)_dense", r".adapter_\1.0"),
    (r"\.adapter_(\d+)_norm", r".adapter_\1.1"),
    (r"\.layer_(\d+)_pointconv", r".layer_\1.0"),
    (r"\.layer_(\d+)_norm", r".layer_\1.1"),
    (r"^head\.predictor", r"sem_seg_head.predictor"),
    (r"\.input_proj_(\d+)", r".input_proj.\1"),
    (r"\.cross_(\d+)", r".transformer_cross_attention_layers.\1"),
    (r"\.self_(\d+)", r".transformer_self_attention_layers.\1"),
    (r"\.ffn_(\d+)", r".transformer_ffn_layers.\1"),
    (r"\.mask_embed\.layers_(\d+)", r".mask_embed.layers.\1"),
)
# the grid pixel decoder's FPN norms are detectron2 Conv2d norms; the
# point-cloud decoder's are the second entry of a Sequential (_RULES)
_GRID_RULES = ((r"\.(adapter|layer)_(\d+)_norm$", r".\1_\2.norm"),)
# the R50's FrozenBN: constant statistics, no batch counter
_FROZEN_BN = re.compile(r"(stem_)?(conv\d|shortcut)_norm")
_LEAF = {"bias": "bias", "scale": "weight", "embedding": "weight",
         "mean": "running_mean", "var": "running_var"}
_MHA = ("q_proj", "k_proj", "v_proj")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _module_name(path: Tuple[str, ...], grid: bool = False) -> str:
    name = ".".join(path)
    for pat, rep in (_GRID_RULES + _RULES) if grid else _RULES:
        name = re.sub(pat, rep, name)
    return name


def is_grid_tree(paths) -> bool:
    """Whether the flax paths hold the grid pixel decoder (its FPN
    convolutions), whose FPN norms take ``_GRID_RULES``."""
    return any(re.fullmatch(r"(adapter|layer)_\d+_conv", part) for path in paths for part in path)


def torch_name(path: Tuple[str, ...], grid: bool = False) -> str:
    """The port's name of the tensor that the JAX parameter leaf at ``path``
    lands on (the three projections of an attention layer land on its one
    ``in_proj_weight`` / ``in_proj_bias``); ``grid`` for a tree with the grid
    pixel decoder (``is_grid_tree``)."""
    *mod, leaf = path
    if leaf == "level_embed" and mod[-1] == "pixel_decoder":
        return _module_name(tuple(mod), grid) + ".transformer.level_embed"
    if leaf in ("kernel", "bias") and mod[-1] in _MHA:
        return _module_name(tuple(mod[:-1]), grid) + (".in_proj_weight" if leaf == "kernel"
                                                      else ".in_proj_bias")
    if leaf == "kernel":
        return _module_name(tuple(mod), grid) + ".weight"
    # a bare parameter (blank_k, blank_v, shepard_power, gamma1/2, rel_pos_emb,
    # scale_emb, relative_position_bias_table) keeps its name
    return _module_name(tuple(mod), grid) + "." + _LEAF.get(leaf, leaf)


def flax_to_torch_state_dict(params: Mapping, batch_stats: Mapping = None) -> Dict[str, torch.Tensor]:
    """params / batch_stats: the JAX MaskFormer's, MaskFormerSwin's or
    MaskFiner's variable trees (arrays or numpy) -> {reference name: tensor}
    for the port model's ``load_state_dict``."""
    sd: Dict[str, np.ndarray] = {}
    mha: Dict[str, Dict[str, np.ndarray]] = {}
    flat = _flatten(params)
    grid = is_grid_tree(flat)
    for path, value in flat.items():
        *mod, leaf = path
        if leaf in ("kernel", "bias") and mod[-1] in _MHA:
            mha.setdefault(_module_name(tuple(mod[:-1]), grid), {})[f"{mod[-1]}.{leaf}"] = value
        elif leaf == "kernel":
            sd[torch_name(path, grid)] = (np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4
                                          else value.T)
        else:
            sd[torch_name(path, grid)] = value
    for name, parts in mha.items():
        sd[name + ".in_proj_weight"] = np.concatenate([parts[f"{p}.kernel"].T for p in _MHA])
        sd[name + ".in_proj_bias"] = np.concatenate([parts[f"{p}.bias"] for p in _MHA])
    for path, value in _flatten(batch_stats or {}).items():
        *mod, leaf = path
        sd[_module_name(tuple(mod)) + "." + _LEAF[leaf]] = value
        if leaf == "mean" and not _FROZEN_BN.fullmatch(mod[-1]):
            sd[_module_name(tuple(mod)) + ".num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v)).contiguous() for k, v in sd.items()}


def read_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint -> {name: tensor}: a detectron2 ``.pkl``
    (pickle, latin1) or a torch file; the weights are unwrapped from a
    ``"model"`` entry, then from a ``"state_dict"`` entry, where the file has
    them, entries that are not arrays are dropped and a leading ``module.``
    (a DataParallel save) is stripped from every name."""
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        data = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(data, Mapping) and isinstance(data.get(key), Mapping):
            data = data[key]
    return {re.sub(r"^module\.", "", k): torch.as_tensor(v)
            for k, v in data.items() if hasattr(v, "shape")}


def load_reference_weights(model: torch.nn.Module, path: str
                           ) -> Optional[Tuple[int, List[str]]]:
    """Copy every entry of ``model.state_dict()`` that the checkpoint at
    ``path`` has into the model; the rest keep their values.  A shape that
    differs raises.  Prints the count as the reference's loader does and
    returns (hits, the names the file lacks); None, with a note, when the
    file is missing (training from scratch)."""
    if not os.path.exists(path):
        print(f"[convert_checkpoint] {path} not found; training from scratch", flush=True)
        return None
    loaded = read_reference_state_dict(path)
    merged, misses = model.state_dict(), []
    for name, cur in merged.items():
        if name not in loaded:
            misses.append(name)
            continue
        if tuple(loaded[name].shape) != tuple(cur.shape):
            raise ValueError(f"shape mismatch at {name}: {tuple(cur.shape)} vs "
                             f"{tuple(loaded[name].shape)}")
        merged[name] = loaded[name].to(dtype=cur.dtype)
    model.load_state_dict(merged)
    hits = len(merged) - len(misses)
    print(f"[convert_checkpoint] loaded {hits}/{len(merged)} tensors"
          + (f"; missing e.g. {misses[:5]}" if misses else ""), flush=True)
    return hits, misses
