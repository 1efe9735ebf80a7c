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
    (r"^backbone\.layers_(\d+)", r"backbone.layers.\1"),
    (r"\.blocks_(\d+)", r".blocks.\1"),
    (r"\.weight_net\.linear", r".weight_net.0"),
    (r"\.weight_net\.norm", r".weight_net.1"),
    (r"^head\.pixel_decoder", r"sem_seg_head.pixel_decoder"),
    (r"\.input_proj_(\d+)_dense", r".input_proj.\1.0"),
    (r"\.input_proj_(\d+)_norm", r".input_proj.\1.1"),
    (r"\.encoder_layer_(\d+)", r".transformer.encoder.layers.\1"),
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


def _module_name(path: Tuple[str, ...]) -> str:
    name = ".".join(path)
    for pat, rep in _RULES:
        name = re.sub(pat, rep, name)
    return name


def flax_to_torch_state_dict(params: Mapping, batch_stats: Mapping = None) -> Dict[str, torch.Tensor]:
    """params / batch_stats: the JAX MaskFormer's variable trees (arrays or
    numpy) -> {reference name: tensor} for ``MaskFormer.load_state_dict``."""
    sd: Dict[str, np.ndarray] = {}
    mha: Dict[str, Dict[str, np.ndarray]] = {}
    for path, value in _flatten(params).items():
        *mod, leaf = path
        if leaf == "level_embed" and mod[-1] == "pixel_decoder":
            sd[_module_name(tuple(mod)) + ".transformer.level_embed"] = value
        elif leaf in ("kernel", "bias") and mod[-1] in _MHA:
            mha.setdefault(_module_name(tuple(mod[:-1])), {})[f"{mod[-1]}.{leaf}"] = value
        elif leaf == "kernel":
            w = np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4 else value.T
            sd[_module_name(tuple(mod)) + ".weight"] = w
        elif leaf in _LEAF:
            sd[_module_name(tuple(mod)) + "." + _LEAF[leaf]] = value
        else:  # a bare parameter: blank_k, blank_v, shepard_power, gamma1/2
            sd[_module_name(tuple(mod)) + "." + leaf] = value
    for name, parts in mha.items():
        sd[name + ".in_proj_weight"] = np.concatenate([parts[f"{p}.kernel"].T for p in _MHA])
        sd[name + ".in_proj_bias"] = np.concatenate([parts[f"{p}.bias"] for p in _MHA])
    for path, value in _flatten(batch_stats or {}).items():
        *mod, leaf = path
        sd[_module_name(tuple(mod)) + "." + _LEAF[leaf]] = value
        if leaf == "mean":
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
