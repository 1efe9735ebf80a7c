"""Model analysis: parameters, structure, peak memory and FLOPs of one eval
forward.

    python -m autofocusformermod_torch.tools.analyze_model --config-file configs/...yaml \\
        --tasks param structure memory flop [--input-size 512] [--device cpu] [KEY VALUE ...]

Counterpart of ``tools/analyze_model.py``.  The model is the one
MODEL.META_ARCHITECTURE names (``models/registry.py:build_model``; the JAX
tool builds a MaskFormer whatever the name), built under cfg.SEED; without
``--config-file`` the ``aff_mini`` preset.

- ``param``: the parameter count, exact; ``structure`` adds each
  parameter's name, shape and size.  Where no other task is asked for,
  the model is built on the ``meta`` device (shapes without storage or
  initialisation).
- ``memory``: the card's peak allocated bytes over one eval forward of one
  ``--input-size`` square image (``torch.cuda.max_memory_allocated``, the
  weights included).  The JAX tool prints XLA's compiled buffer sizes
  instead; the two are not comparable.
- ``flop``: ``torch.utils.flop_counter.FlopCounterMode`` over one eval
  forward through the plain versions on the CPU: it counts the aten
  operations it has formulas for (matmuls, convolutions, attention), so
  the kernels' work, gathers and elementwise operations are not in it.  It
  is not held to the JAX tool's XLA estimate.

The tool takes the first CUDA device unless ``--device cpu`` is given (then
``memory`` is not measured), and fails at once without one.  ``main``
returns the numbers it printed.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
from typing import Dict, Optional, Sequence

import torch

from ..config import PRESETS, published_cfg
from ..models.registry import build_model
from ..ops.dispatch import plain_versions
from ..parallel import precision

TASKS = ("param", "structure", "memory", "flop")


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="autofocusformermod_torch model analysis")
    ap.add_argument("--config-file", default="", metavar="FILE")
    ap.add_argument("--tasks", nargs="+", default=["flop", "param"], choices=TASKS)
    ap.add_argument("--input-size", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return ap


def build(args: argparse.Namespace):
    if args.config_file:
        cfg = published_cfg(args.config_file, args.opts)
    else:
        cfg = PRESETS["aff_mini"]()
        cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    shapes_only = set(args.tasks) <= {"param", "structure"}
    with torch.random.fork_rng(devices=[]), \
            torch.device("meta") if shapes_only else contextlib.nullcontext():
        torch.manual_seed(cfg.SEED)
        model = build_model(cfg)
    return cfg, model.eval()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = get_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("analyze_model: no CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to run on the CPU")
    cfg, model = build(args)
    s, out = args.input_size, {}
    x = torch.zeros((1, s, s, 3), dtype=torch.uint8)

    if "param" in args.tasks or "structure" in args.tasks:
        rows = [(name, tuple(p.shape), p.numel()) for name, p in model.named_parameters()]
        out["parameters"] = total = sum(r[2] for r in rows)
        print(f"total parameters: {total / 1e6:.2f} M ({total})")
        if "structure" in args.tasks:
            for name, shape, size in rows:
                print(f"  {name:80s} {str(shape):24s} {size}")

    if "flop" in args.tasks:
        from torch.utils.flop_counter import FlopCounterMode

        cpu_model = copy.deepcopy(model).cpu()
        # with autograd on: FlopCounterMode's module tracker asserts a
        # gradient function on the modules' outputs
        with plain_versions(), FlopCounterMode(display=False) as counter:
            precision.apply(cpu_model, x)
        out["flops"] = flops = counter.get_total_flops()
        print(f"aten-op FLOPs of one eval forward ({s}x{s}, plain versions on the CPU, "
              f"torch.utils.flop_counter): {flops / 1e9:.2f} GFLOPs; counts matmuls, "
              "convolutions and attention only, not held to XLA's estimate")

    if "memory" in args.tasks:
        if args.device == "cpu":
            print("memory: not measured (the card's peak bytes; --device cpu)")
        else:
            dev = torch.device("cuda", 0)
            model = model.to(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with torch.no_grad():
                precision.apply(model, x.to(dev))
            torch.cuda.synchronize()
            out["peak_bytes"] = peak = torch.cuda.max_memory_allocated(dev)
            print(f"peak memory of one eval forward ({s}x{s}, weights included): "
                  f"{peak / 2 ** 20:.1f} MiB ({torch.cuda.get_device_name(dev)})")
    return out


if __name__ == "__main__":
    main()
