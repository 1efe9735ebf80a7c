"""Training and evaluation CLI of the PyTorch port.

    python -m autofocusformermod_torch.train_net --config-file configs/...yaml \\
        [--synthetic] [--max-iter 100] [--resume] [--eval-only] [--device cpu] [KEY VALUE ...]
    python -m autofocusformermod_torch.train_net --config aff_small [...]

Counterpart of the JAX package's ``train_net.py``, with its flags.
``--config-file`` merges a published yaml (and its ``_BASE_`` files) over
the default tree (``config.published_cfg``; read by the port's own yaml
reader, no PyYAML); ``--config`` names a preset instead, a short name
for one of those yamls (``config.PRESET_YAMLS``; the two exclude each
other; neither gives the ``aff_mini`` preset).  KEY VALUE pairs override fields
(``SOLVER.IMS_PER_BATCH 8 OUTPUT_DIR runs/small``), then the config is
frozen.  ``--num-gpus``, ``--num-machines``, ``--machine-rank`` and
``--dist-url`` are accepted as the JAX command accepts them; the port runs
one process on one device, so more than one GPU or machine raises
(multi-GPU is ROADMAP.md section 1 item 6).  The run takes the first CUDA
device; ``--device cpu`` asks for the CPU, and without a CUDA device and
without that flag the command fails at once.  Training reads
DATASETS.TRAIN (registered under $DETECTRON2_DATASETS) through the mapper
INPUT.DATASET_MAPPER_NAME names, and evaluates DATASETS.TEST every
TEST.EVAL_PERIOD steps; ``--synthetic`` trains on seeded synthetic batches
instead.  ``--max-iter N`` stops (with a checkpoint) after step N;
``--resume`` continues from the latest checkpoint under OUTPUT_DIR.
``--eval-only`` evaluates the model (the latest checkpoint with
``--resume``, else MODEL.WEIGHTS) on DATASETS.TEST, prints the metrics and
trains nothing.  Every ported meta-architecture trains.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from .config import PRESETS, published_cfg
from .data.synthetic import synthetic_batches
from .engine.train import Trainer, require_trainable

DEFAULT_PRESET = "aff_mini"
MULTI_GPU = "multi-GPU training is not ported (ROADMAP.md section 1 item 6, multi-GPU)"


def default_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="autofocusformermod_torch training")
    source = parser.add_mutually_exclusive_group()
    source.add_argument("--config-file", default="", metavar="FILE",
                        help="a yaml under configs/, merged over the default tree")
    source.add_argument("--config", default=None, choices=sorted(PRESETS),
                        help=f"a preset (default {DEFAULT_PRESET} when no --config-file)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true",
                        help="evaluate on DATASETS.TEST and exit")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on seeded synthetic batches")
    parser.add_argument("--max-iter", type=int, default=None,
                        help="stop after this step (the schedule still runs to SOLVER.MAX_ITER)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--num-gpus", type=int, default=1, help="1: one process, one device")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto", help="accepted; one process needs none")
    parser.add_argument("--wandb-name", default=None)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE pairs")
    return parser


def setup(args: argparse.Namespace):
    """The frozen config of the parsed arguments: the yaml over the default
    tree, or the preset, with the overrides merged."""
    if args.num_gpus > 1 or args.num_machines > 1 or args.machine_rank:
        raise NotImplementedError(f"{MULTI_GPU}: --num-gpus {args.num_gpus} --num-machines "
                                  f"{args.num_machines} --machine-rank {args.machine_rank}")
    if args.config_file:
        cfg = published_cfg(args.config_file, args.opts or ())
    else:
        cfg = PRESETS[args.config or DEFAULT_PRESET]()
        cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Run the command; returns the Trainer after its last step (with
    ``--eval-only``, after its evaluation; the metrics of the latest
    evaluation are in ``trainer.results``)."""
    args = default_argument_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_net: no CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to train on the CPU")
    cfg = setup(args)
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
