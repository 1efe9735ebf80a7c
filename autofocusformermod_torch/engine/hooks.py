"""Training hooks: the NaN watchdog, device-memory statistics, metric logging.

Counterpart of ``autofocusformermod_tpu/engine/hooks.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import torch
from torch import nn


def nan_check(model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None) -> List[str]:
    """Names of the parameters, buffers and optimizer-state tensors that hold
    a NaN or an Inf (printed when there are any)."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    if optimizer is not None:
        names = {p: n for n, p in model.named_parameters()}
        for p, state in optimizer.state.items():
            named += [(f"optimizer.{names.get(p, '?')}.{k}", v) for k, v in state.items()
                      if torch.is_tensor(v)]
    bad = [n for n, t in named if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        print(f"[nan_check] non-finite values in {bad[:10]}", flush=True)
    return bad


def device_memory_stats(device: torch.device) -> Dict[str, int]:
    """The card's memory in bytes: in use, the peak since the process began
    (or the last reset), and the card's total.  Empty for the CPU."""
    if device.type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}


class MetricLogger:
    """Scalars to stdout every ``period`` steps and, with an output
    directory, to ``metrics.jsonl`` on every step; to TensorBoard and wandb
    too where those packages are installed."""

    def __init__(self, output_dir: Optional[str] = None, period: int = 20,
                 wandb_name: Optional[str] = None):
        self.period = period
        self.path = None
        self._tb = None
        self._wandb = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self.path = os.path.join(output_dir, "metrics.jsonl")
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir=os.path.join(output_dir, "tb"))
        if wandb_name:
            try:
                import wandb
            except ImportError:
                pass
            else:
                self._wandb = wandb
                wandb.init(project="CandidateNet", name=wandb_name,
                           sync_tensorboard=self._tb is not None)
        self._t0 = time.perf_counter()
        self._last_step = 0

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"step": step, **scalars}) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if step % self.period == 0:
            now = time.perf_counter()
            steps = max(step - self._last_step, 1)
            brief = {k: round(v, 4) for k, v in scalars.items()
                     if not k.startswith("loss_") or k.endswith(("_ce", "_mask", "_dice"))}
            print(f"[step {step}] {brief} ({(now - self._t0) / steps:.3f}s/it)", flush=True)
            self._t0, self._last_step = now, step

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
