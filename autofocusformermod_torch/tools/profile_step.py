"""Where a training step's time goes on the card.

    python3 -m autofocusformermod_torch.tools.profile_step --config aff_small --batch 8
    python3 -m autofocusformermod_torch.tools.profile_step --config maskfiner_mini --batch 4
    python3 -m autofocusformermod_torch.tools.profile_step --config swin_base_384_res640 --batch 2
    python3 -m autofocusformermod_torch.tools.profile_step --config maskfiner_updown_mini --batch 4
    python3 -m autofocusformermod_torch.tools.profile_step --config mrmlnb_mini --batch 4
    MSDETRPC_STACKED=0 python3 -m autofocusformermod_torch.tools.profile_step \\
        --config aff_mini --opts INPUT.CROP.SIZE "[384, 384]"

Builds the Trainer of a preset (any meta-architecture: the MaskFiner
cascades', the MRML models' and the grid baselines' steps call the same
criterion and sampler; seeded weights,
synthetic batches; ``--opts``
overrides config fields as KEY VALUE pairs; ``MSDETRPC_STACKED=0`` turns the
pixel decoder's ``USE_STACKED_GLUE`` off, which takes the interleaved kernel
where the levels are not all multiples of 128), takes 3 steps to warm up,
times 5 and profiles 2 more, and reports per step: the wall time (host clock
around a synchronised step), the time on the stream of the criterion and,
inside it, of the uncertainty sampler (CUDA events around the calls: device
work and the gaps the host leaves, not busy time), the device's busy time
and share (the sum of the profiler's kernel and memcpy rows), the number of
kernels launched, and the kernels that take
the most device time.  The busy share is taken against the unprofiled
steps' wall time: the profiler slows the host, not the kernels.  Prints one
JSON object last.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from typing import Optional, Sequence

WARMUP, TIMED, PROFILED = 3, 5, 2     # steps: untimed, timed, under the profiler


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..config import PRESETS, train_image_size
    from ..data.synthetic import synthetic_batches
    from ..engine import train_step
    from ..engine.train import Trainer
    from ..losses import criterion
    from ..models import pixel_decoder

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="aff_small", choices=sorted(PRESETS))
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--opts", nargs="*", default=[], metavar="KEY VALUE")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    spans = {"criterion": [], "sampler": []}

    def on_stream(name, fn):
        def wrapped(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return wrapped

    with tempfile.TemporaryDirectory() as out_dir:
        cfg = PRESETS[args.config]()
        cfg.merge_from_list([*args.opts, "SOLVER.IMS_PER_BATCH", str(args.batch),
                             "OUTPUT_DIR", out_dir])
        trainer = Trainer(cfg, dev)
        batches = synthetic_batches(cfg, dev)
        originals = (train_step.set_criterion, criterion._uncertain_coords)
        train_step.set_criterion = on_stream("criterion", originals[0])
        criterion._uncertain_coords = on_stream("sampler", originals[1])
        try:
            def step():
                batch = next(batches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.step_fn(batch, trainer.draw)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            for _ in range(WARMUP):
                step()
            for v in spans.values():
                v.clear()
            torch.cuda.reset_peak_memory_stats()
            wall = [step() for _ in range(TIMED)]
            on = {k: statistics.median(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prof_wall = sum(step() for _ in range(PROFILED))
        finally:
            train_step.set_criterion, criterion._uncertain_coords = originals

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / PROFILED
    launches = sum(e.count for e in rows) / PROFILED
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:15]
    result = {
        "card": smi, "config": args.config, "opts": args.opts,
        "use_stacked_glue": pixel_decoder.USE_STACKED_GLUE,
        "batch": args.batch, "image_size": list(train_image_size(cfg)),
        "ms_per_step": statistics.median(wall), "ms_per_step_all": wall,
        "images_per_s": args.batch / statistics.median(wall) * 1e3, "peak_gib": peak,
        "criterion_stream_ms": on["criterion"], "sampler_stream_ms": on["sampler"],
        "profiled_ms_per_step": prof_wall / PROFILED, "device_busy_ms_per_step": busy,
        "device_busy_share": busy / statistics.median(wall),
        "device_rows_per_step": launches,
        "top_kernels_ms_per_step": [[e.key[:80], e.self_device_time_total / 1e3 / PROFILED,
                                     e.count / PROFILED] for e in top]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
