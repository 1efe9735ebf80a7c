"""Checkpoints of a training run, with resume from the latest and bounded
retention.

Counterpart of ``autofocusformermod_tpu/engine/checkpoint.py`` over
``torch.save``: one file per step, ``step_<step>.pt``, written under a
temporary name and renamed, so a run killed while saving leaves no torn
file.  A state holds tensors, numbers, strings and containers of them only,
and is read back with ``weights_only=True``.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def steps(self) -> List[int]:
        """The steps that have a checkpoint, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: Any) -> None:
        """Write the state of ``step``, then delete the oldest checkpoints
        beyond ``max_to_keep``."""
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def wait(self) -> None:
        """Saves are synchronous, so there is nothing to wait for (the JAX
        package's saves are asynchronous; callers written against it call
        this before they exit)."""

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The state of ``step`` (default: the latest) with its tensors on the
        CPU, or None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)
