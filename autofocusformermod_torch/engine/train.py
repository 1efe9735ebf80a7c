"""Trainer: config -> model, optimizer and training step on one device, and
the train loop with checkpoints, resume, the NaN watchdog and metric logging.

Counterpart of ``autofocusformermod_tpu/engine/train.py``.  The batches come
from the caller (``data.synthetic.synthetic_batches`` where no dataset is
installed); reading a dataset and evaluating wait for the ``data/`` and
``evaluation/`` packages (ROADMAP.md).

Randomness: the weights are initialised under cfg.SEED, and two generators
on the device -- the criterion's (cfg.SEED + 1) and DropPath's (cfg.SEED +
2) -- carry the run's streams.  A checkpoint holds their states with the
model's (parameters and BatchNorm statistics), the optimizer's and the
schedule's, so a resumed run continues the stream the interrupted one left.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Iterator, Optional

import torch

from ..losses.criterion import device_draw
from ..models.maskformer import maskformer_from_config
from .checkpoint import Checkpointer
from .convert_checkpoint import load_reference_weights
from .hooks import MetricLogger, device_memory_stats, nan_check
from .train_step import TrainStep


class Trainer:
    """``Trainer(cfg, device)``; ``resume_or_load()``; ``train(batches)``."""

    def __init__(self, cfg, device: torch.device, wandb_name: Optional[str] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.SEED)
            model = maskformer_from_config(cfg)
        self.model = model.to(self.device)
        self.step_fn = TrainStep(self.model, cfg)
        self.generators = {
            "criterion": torch.Generator(device=self.device).manual_seed(cfg.SEED + 1),
            "drop_path": torch.Generator(device=self.device).manual_seed(cfg.SEED + 2)}
        self.draw = device_draw(self.generators["criterion"])
        self.model.backbone.set_drop_path_generator(self.generators["drop_path"])
        self.checkpointer = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "checkpoints"))
        self.logger = MetricLogger(cfg.OUTPUT_DIR, wandb_name=wandb_name)
        self.start_step = 0

    # -------------------------------------------------------------- resume
    def state(self, step: int) -> Dict:
        return {"step": step, "model": self.model.state_dict(),
                "optimizer": self.step_fn.optimizer.state_dict(),
                "scheduler": self.step_fn.scheduler.state_dict(),
                "generators": {k: g.get_state() for k, g in self.generators.items()}}

    def load_state(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        self.step_fn.optimizer.load_state_dict(state["optimizer"])
        self.step_fn.scheduler.load_state_dict(state["scheduler"])
        for k, g in self.generators.items():
            g.set_state(state["generators"][k])
        self.start_step = int(state["step"])

    def resume_or_load(self, resume: bool = True) -> None:
        """Continue from the latest checkpoint under OUTPUT_DIR when ``resume``
        is set and there is one; else merge the reference checkpoint
        MODEL.WEIGHTS (``convert_checkpoint.load_reference_weights``: the
        entries it has, by name, with a count) when that file exists."""
        weights = self.cfg.MODEL.WEIGHTS
        if resume and self.checkpointer.latest_step() is not None:
            self.load_state(self.checkpointer.restore())
            print(f"resumed from step {self.start_step}", flush=True)
        elif weights:
            load_reference_weights(self.model, weights)

    # --------------------------------------------------------------- train
    def build_train_loader(self):
        raise NotImplementedError(
            "reading a dataset waits for the port of data/ (ROADMAP.md, the data/ + "
            "evaluation/ slice): pass train() an iterator of batches, for one "
            "data.synthetic.synthetic_batches")

    def test(self):
        raise NotImplementedError(
            "evaluation waits for the port of data/ and evaluation/ (ROADMAP.md, the data/ + "
            "evaluation/ slice)")

    def train(self, batches: Iterator[Dict[str, torch.Tensor]],
              max_iter: Optional[int] = None) -> None:
        """Steps start_step + 1 .. SOLVER.MAX_ITER, or up to ``max_iter`` when
        that is lower (the schedule still runs to SOLVER.MAX_ITER), one batch
        of ``batches`` each.  A checkpoint every SOLVER.CHECKPOINT_PERIOD
        steps and after the last one."""
        solver = self.cfg.SOLVER
        last = solver.MAX_ITER if max_iter is None else min(max_iter, solver.MAX_ITER)
        for step in range(self.start_step + 1, last + 1):
            batch = next(batches)
            t0 = time.perf_counter()
            metrics = {k: float(v) for k, v in self.step_fn(batch, self.draw).items()}
            metrics["seconds"] = time.perf_counter() - t0    # float() waited for the device
            metrics.update(device_memory_stats(self.device))
            self.logger.log(step, metrics)
            if not math.isfinite(metrics["total_loss"]):
                nan_check(self.model, self.step_fn.optimizer)
                raise FloatingPointError(f"non-finite loss at step {step}")
            if step % solver.CHECKPOINT_PERIOD == 0 or step == last:
                self.checkpointer.save(step, self.state(step))
            self.start_step = step
        self.checkpointer.wait()
        self.logger.close()
