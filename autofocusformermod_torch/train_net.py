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
frozen.  ``--num-gpus N`` trains data parallel in N processes on this
machine, one a GPU (``parallel/mesh.py launch``: NCCL, rank i on
``cuda:i``; with ``--device cpu``, N gloo processes on the CPU);
``--num-machines``, ``--machine-rank`` and ``--dist-url`` mean what they
mean to detectron2's ``launch`` (global rank = machine rank * N + local
rank; ``auto`` picks a free local port on one machine).  More GPUs than
the machine has refuses.  Under ``torchrun`` (WORLD_SIZE, RANK,
LOCAL_RANK in the environment) the process joins that group instead and
takes ``cuda:LOCAL_RANK``.  SOLVER.IMS_PER_BATCH is the global batch.
One process takes the first CUDA device; ``--device cpu`` asks for the
CPU, and without a CUDA device and without that flag the command fails at
once.  Training reads
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
import sys
from typing import Optional, Sequence

import torch

from .config import PRESETS, published_cfg
from .data.synthetic import synthetic_batches
from .engine.train import Trainer, require_trainable
from .parallel import mesh

DEFAULT_PRESET = "aff_mini"


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
    parser.add_argument("--num-gpus", type=int, default=1,
                        help="processes on this machine, one a GPU (CPU processes with --device "
                             "cpu)")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0,
                        help="this machine's rank (unique per machine)")
    parser.add_argument("--dist-url", default="auto",
                        help="the group's rendezvous, tcp://host:port or file://path; auto: a "
                             "free local port (one machine)")
    parser.add_argument("--wandb-name", default=None)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE pairs")
    return parser


def setup(args: argparse.Namespace):
    """The frozen config of the parsed arguments: the yaml over the default
    tree, or the preset, with the overrides merged."""
    if args.config_file:
        cfg = published_cfg(args.config_file, args.opts or ())
    else:
        cfg = PRESETS[args.config or DEFAULT_PRESET]()
        cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> Optional[Trainer]:
    """Run the command; returns the Trainer after its last step (with
    ``--eval-only``, after its evaluation; the metrics of the latest
    evaluation are in ``trainer.results``), or None where the run was
    spawned into ``--num-gpus`` processes."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = default_argument_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_net: no CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to train on the CPU")
    cfg = setup(args)
    if not args.eval_only:
        require_trainable(cfg)
    local_rank = mesh.init_from_env(args.device)
    if local_rank is not None:                    # a torchrun process
        device = torch.device("cuda", local_rank) if args.device == "cuda" else torch.device("cpu")
        try:
            return run(device, args, cfg)
        finally:
            mesh.shutdown()
    if args.num_gpus * args.num_machines > 1:
        if args.device == "cuda" and args.num_gpus > torch.cuda.device_count():
            raise SystemExit(f"train_net: --num-gpus {args.num_gpus} asks for {args.num_gpus} "
                             f"GPUs; this machine has {torch.cuda.device_count()} CUDA device(s)")
        mesh.launch(_rank_main, args.num_gpus, args.num_machines, args.machine_rank,
                    args.dist_url, args.device, args=(argv,))
        return None
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    return run(device, args, cfg)


def _rank_main(device: torch.device, argv: Sequence[str]) -> None:
    """One spawned process of ``--num-gpus``: the command's run on its device."""
    args = default_argument_parser().parse_args(argv)
    run(device, args, setup(args))


def run(device: torch.device, args: argparse.Namespace, cfg) -> Trainer:
    """Train or evaluate on ``device`` (a rank of the group where one is active)."""
    trainer = Trainer(cfg, device, wandb_name=args.wandb_name)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        results = trainer.test()
        if trainer.is_main:
            print(results, flush=True)
        return trainer
    batches = synthetic_batches(cfg, trainer.device, trainer.start_step) if args.synthetic else None
    trainer.train(batches, max_iter=args.max_iter)
    return trainer


if __name__ == "__main__":
    main()
