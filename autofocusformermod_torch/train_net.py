"""Training and evaluation CLI of the PyTorch port.

    python -m autofocusformermod_torch.train_net --config aff_small \\
        [--synthetic] [--max-iter 100] [--resume] [--eval-only] [--device cpu] [KEY VALUE ...]

Counterpart of the JAX package's ``train_net.py``, with its flags where they
apply.  ``--config`` names a preset of ``autofocusformermod_torch.config``
(reading the yaml files needs PyYAML); KEY VALUE pairs override its fields
(``SOLVER.IMS_PER_BATCH 8 OUTPUT_DIR runs/small``).  The run takes the first
CUDA device; ``--device cpu`` asks for the CPU, and without a CUDA device
and without that flag the command fails at once.  Training reads
DATASETS.TRAIN (registered under $DETECTRON2_DATASETS) through the semantic
mapper, and evaluates DATASETS.TEST every TEST.EVAL_PERIOD steps;
``--synthetic`` trains on seeded synthetic batches instead.  ``--max-iter
N`` stops (with a checkpoint) after step N; ``--resume`` continues from the
latest checkpoint under OUTPUT_DIR.  ``--eval-only`` evaluates the model
(the latest checkpoint with ``--resume``, else MODEL.WEIGHTS) on
DATASETS.TEST, prints the metrics and trains nothing.  Every ported
meta-architecture trains: ``--config maskfiner_mini`` trains the MaskFiner
cascade, ``--config maskfiner_updown_mini`` (or ``maskfiner_oracle_teacher_bb``)
the OracleTeacher-BB cascade with its upsampling loss, ``--config r50`` and
``--config swin_base_384_res640`` (or ``swin_tiny``) the grid baselines.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from .config import PRESETS
from .data.synthetic import synthetic_batches
from .engine.train import Trainer, require_trainable


def default_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="autofocusformermod_torch training")
    parser.add_argument("--config", default="aff_mini", choices=sorted(PRESETS))
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true",
                        help="evaluate on DATASETS.TEST and exit")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on seeded synthetic batches")
    parser.add_argument("--max-iter", type=int, default=None,
                        help="stop after this step (the schedule still runs to SOLVER.MAX_ITER)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--wandb-name", default=None)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE pairs")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Run the command; returns the Trainer after its last step (with
    ``--eval-only``, after its evaluation; the metrics of the latest
    evaluation are in ``trainer.results``)."""
    args = default_argument_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_net: no CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to train on the CPU")
    cfg = PRESETS[args.config]()
    cfg.merge_from_list(args.opts or [])
    if not args.eval_only:
        require_trainable(cfg)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    trainer = Trainer(cfg, device, wandb_name=args.wandb_name)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        print(trainer.test(), flush=True)
        return trainer
    batches = synthetic_batches(cfg, trainer.device, trainer.start_step) if args.synthetic else None
    trainer.train(batches, max_iter=args.max_iter)
    return trainer


if __name__ == "__main__":
    main()
