"""The configuration node: a yacs-compatible ``CfgNode`` without PyYAML.

Counterpart of ``autofocusformermod_tpu/config/cfg_node.py``, with its
semantics: attribute access, ``freeze`` / ``defrost`` / ``is_frozen``,
``clone``, ``merge_from_other_cfg``, ``merge_from_file`` (``_BASE_`` files
resolved relative to the file and merged first; every string leaf read from
a file ``literal_eval``'d where it parses, as yacs does, so ``(512, 512)``
is a tuple and ``RGB`` stays a string) and ``merge_from_list`` (KEY VALUE
overrides of existing fields, coerced as the JAX package's
``_decode_value`` coerces them: int to bool or float, list to tuple and
back, anything over a None).  Files are read by ``yaml_reader``, the port's
own reader of the subset the configs use.

Where the JAX node accepts an override the port accepts the same value;
where it refuses one the port refuses it too, with an exception that names
the problem: KeyError for a field that does not exist (or a whole node),
TypeError for a value of another type, ValueError for an odd-length list
(the JAX node raises AssertionError, ValueError and AssertionError).
"""

from __future__ import annotations

import ast
import copy
import math
import os
from typing import Any, List, Sequence

from . import yaml_reader

_FROZEN = "__frozen__"
BASE_KEY = "_BASE_"


class CfgNode(dict):
    """dict with attribute access and yacs-style merge semantics."""

    def __init__(self, init_dict=None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        for k, v in (init_dict or {}).items():
            self[k] = self._to_node(v)

    @classmethod
    def _to_node(cls, v):
        if isinstance(v, dict) and not isinstance(v, CfgNode):
            return cls(v)
        return v

    # -- attribute access ----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Attempted to set {name} to {value}, but CfgNode is frozen")
        self[name] = self._to_node(value)

    # -- freeze --------------------------------------------------------------
    def freeze(self) -> None:
        self._set_frozen(True)

    def defrost(self) -> None:
        self._set_frozen(False)

    def _set_frozen(self, frozen: bool) -> None:
        object.__setattr__(self, _FROZEN, frozen)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            out[k] = copy.deepcopy(v, memo)
        return out

    # -- merging -------------------------------------------------------------
    def _refuse_frozen(self) -> None:
        if self.is_frozen():
            raise AttributeError("Attempted to merge into a frozen CfgNode")

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._refuse_frozen()
        _merge_a_into_b(other, self)

    def merge_from_file(self, cfg_filename: str) -> None:
        self._refuse_frozen()
        _merge_a_into_b(CfgNode(load_yaml_with_base(cfg_filename)), self)

    def merge_from_list(self, cfg_list: Sequence[str]) -> None:
        self._refuse_frozen()
        if len(cfg_list) % 2:
            raise ValueError(f"overrides come as KEY VALUE pairs, got {list(cfg_list)}")
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            *parents, last = full_key.split(".")
            node = self
            for sub in parents:
                node = node.get(sub) if isinstance(node, CfgNode) else None
            if not isinstance(node, CfgNode) or last not in node or isinstance(node[last],
                                                                               CfgNode):
                raise KeyError(f"no config field {full_key}")
            node[last] = decode_value(v, node[last], full_key)

    def dump(self) -> str:
        """The tree as text ``yaml_reader`` reads back to an equal tree
        (nodes as block mappings, lists as flow sequences, tuples as the
        quoted Python literal that ``merge_from_file`` evaluates back)."""
        return "".join(_dump_lines(self, 0))

    def __repr__(self) -> str:  # pragma: no cover - debug helper
        return f"CfgNode({dict.__repr__(self)})"


def decode_value(value: Any, original: Any, full_key: str) -> Any:
    """An override's value (a Python literal where it parses, else the
    string) coerced to the field's type as the JAX package's
    ``_decode_value`` coerces it."""
    try:
        parsed = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        parsed = value
    if original is None or isinstance(parsed, type(original)):
        return parsed
    if isinstance(original, bool) and isinstance(parsed, int):
        return bool(parsed)
    if isinstance(original, float) and isinstance(parsed, int):
        return float(parsed)
    if isinstance(original, tuple) and isinstance(parsed, list):
        return tuple(parsed)
    if isinstance(original, list) and isinstance(parsed, tuple):
        return list(parsed)
    raise TypeError(f"{full_key}: expected {type(original).__name__}, got {value!r}")


def _merge_a_into_b(a: dict, b: CfgNode) -> None:
    for k, v_a in a.items():
        if k in b and isinstance(b[k], CfgNode) and isinstance(v_a, dict):
            _merge_a_into_b(v_a, b[k])
        else:
            b[k] = CfgNode._to_node(copy.deepcopy(v_a))


def decode_leaves(obj):
    """yacs semantics: every string leaf loaded from a file is
    literal_eval'd where it parses (lists are left as they are)."""
    if isinstance(obj, dict):
        return {k: decode_leaves(v) for k, v in obj.items()}
    if isinstance(obj, str):
        try:
            return ast.literal_eval(obj)
        except (ValueError, SyntaxError):
            return obj
    return obj


def load_yaml_with_base(filename: str) -> dict:
    """The file's tree over its ``_BASE_`` files' (a path or a list of
    paths, relative to the file), bases merged first, in order."""
    cfg = decode_leaves(yaml_reader.load_file(filename) or {})
    base_cfg: dict = {}
    if BASE_KEY in cfg:
        base_files = cfg.pop(BASE_KEY)
        if isinstance(base_files, str):
            base_files = [base_files]
        for base in base_files:
            if not os.path.isabs(base):
                base = os.path.join(os.path.dirname(filename), base)
            _merge_plain(load_yaml_with_base(base), base_cfg)
    _merge_plain(cfg, base_cfg)
    return base_cfg


def _merge_plain(src: dict, dst: dict) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _merge_plain(v, dst[k])
        else:
            dst[k] = copy.deepcopy(v)


def _scalar(v: Any) -> str:
    """One leaf in the reader's subset."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        return repr(v)
    if isinstance(v, list):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    if isinstance(v, (tuple, str)):
        text = repr(v) if isinstance(v, tuple) else v
        return '"' + text.replace("\\", "\\\\").replace('"', '\\"') + '"'
    raise TypeError(f"cannot dump {type(v).__name__} {v!r}")


def _dump_lines(node: dict, indent: int) -> List[str]:
    lines = []
    for k in sorted(node):
        v = node[k]
        if isinstance(v, dict):
            lines.append(" " * indent + f"{k}:\n")
            lines += _dump_lines(v, indent + 2)
        else:
            lines.append(" " * indent + f"{k}: {_scalar(v)}\n")
    return lines
