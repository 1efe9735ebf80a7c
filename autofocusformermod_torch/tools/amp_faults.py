"""What the mixed-precision phase of ``chip_smoke.py`` (phase 19: the published
COCO-panoptic MaskFiner-UpDown-Tiny under SOLVER.AMP.ENABLED) reads when
the program is at fault.  Its limits are opened (every AMP budget and floor
of chip_smoke.py; the kernels' own checks on the phase's operands log their
failure and the phase goes on), and the phase runs once as it is and once
under each named fault, so that the log gives beside each limit the reading
of a sound run and of a faulty one.

    python3 -m autofocusformermod_torch.tools.amp_faults [fault ...]

Faults (made at run time, in this process; no file changes):

- ``none``: no fault;
- ``k1_ulp``: the local-attention kernel's (K1) output times 1 + 2**-8,
  one bf16 unit in the last place;
- ``k1_3pc``: the same, times 1 + 2**-5;
- ``lapjv_roll``: the matching kernel's (K13) assignment moved one query
  on (each target slot gets the next query);
- ``fp32``: the mixed-precision glue quietly computing in fp32: the bf16
  view of the parameters is the fp32 masters and the normalized images
  stay fp32.

Run from the root of the repository on a machine with a CUDA card (one
card).  Writes each run's phase-19 record to
``chiprun_out/amp_faults/<fault>/phase19.json`` and its log to the standard
output.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

FAULTS = ("none", "k1_ulp", "k1_3pc", "lapjv_roll", "fp32")


def open_limits(cs) -> None:
    """Every AMP limit of chip_smoke.py opened; the kernel checks log."""
    cs.AMP_FORWARD_RTOL = cs.AMP_FORWARD_MEAN_RTOL = math.inf
    cs.AMP_LOSS_RTOL = cs.AMP_GROUP_NORM_RTOL = cs.AMP_FP32_BUDGET = math.inf
    cs.AMP_FP32_MIN = cs.AMP_BF16_SHARE_MIN = 0.0
    cs.AMP_STAGE1_DTYPES = None
    cs.AMP_CHOICE_AGREE_MIN = dict.fromkeys(cs.AMP_CHOICE_AGREE_MIN, 0.0)
    for name in ("check_local_attn_calls", "check_msdetrpc", "check_knn",
                 "hold_grid_step_operands"):
        setattr(cs, name, logged(cs, getattr(cs, name)))


def logged(cs, check):
    def run(*args, **kwargs):
        try:
            return check(*args, **kwargs)
        except SystemExit as e:
            cs.log(f"  [{check.__name__} fails: {e}]")
            return {}
    return run


def inject(fault: str):
    """Make `fault`; -> a function that undoes it."""
    from autofocusformermod_torch.losses import matcher
    from autofocusformermod_torch.models.meta_arch_variants import MaskFinerOracleTeacherBB
    from autofocusformermod_torch.ops import local_attn
    from autofocusformermod_torch.parallel import precision

    if fault == "none":
        return lambda: None
    if fault in ("k1_ulp", "k1_3pc"):
        real = local_attn.local_attn_forward
        scale = 1 + 2.0 ** (-8 if fault == "k1_ulp" else -5)

        def scaled(*args, **kwargs):
            out, blank, lse = real(*args, **kwargs)
            return out * scale, blank, lse

        local_attn.local_attn_forward = scaled
        return lambda: setattr(local_attn, "local_attn_forward", real)
    if fault == "lapjv_roll":
        real = matcher.lapjv

        def rolled(cost, *args, **kwargs):
            return (real(cost, *args, **kwargs) + 1) % cost.shape[1]

        matcher.lapjv = rolled
        return lambda: setattr(matcher, "lapjv", real)
    if fault == "fp32":
        view, normalize = precision.amp_parameters, MaskFinerOracleTeacherBB.normalize
        precision.amp_parameters = lambda model: dict(model.named_parameters())
        MaskFinerOracleTeacherBB.normalize = \
            lambda self, images: (images.float() - self.pixel_mean) / self.pixel_std

        def undo():
            precision.amp_parameters = view
            MaskFinerOracleTeacherBB.normalize = normalize
        return undo
    raise SystemExit(f"unknown fault {fault!r}; known: {FAULTS}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("faults", nargs="*", help=f"of {FAULTS} (default: all)")
    args = parser.parse_args()
    for fault in args.faults:
        if fault not in FAULTS:
            parser.error(f"unknown fault {fault!r}; known: {FAULTS}")
    args.faults = args.faults or list(FAULTS)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.losses.lapjv import lapjv
    from autofocusformermod_torch.ops.build import build_library, load_kernels
    from autofocusformermod_torch.ops.local_attn import (sfc_cluster_attention,
                                                         sfc_cluster_attention_backward)
    from autofocusformermod_torch.ops.msdetrpc import msdetrpc_levels_s, msdetrpc_levels_s_backward
    from autofocusformermod_torch.ops.point_sample import (
        point_sample_backward, point_sample_bilinear, point_sample_nearest,
        point_sample_nearest_rows)

    if not torch.cuda.is_available():
        raise SystemExit("amp_faults: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}; torch {torch.__version__}")
    build_library()
    load_kernels()
    counters = {"local_attn": sfc_cluster_attention,
                "local_attn_bwd": sfc_cluster_attention_backward,
                "msdetrpc": msdetrpc_levels_s, "msdetrpc_bwd": msdetrpc_levels_s_backward,
                "point_sample": point_sample_bilinear, "point_sample_bwd": point_sample_backward,
                "lapjv": lapjv, "knn": knn, "point_sample_nearest": point_sample_nearest,
                "point_sample_nearest_rows": point_sample_nearest_rows}
    open_limits(cs)
    for fault in args.faults:
        cs.log(f"fault {fault}: phase 19 with its limits open")
        undo = inject(fault)
        t0 = time.time()
        try:
            cs.amp_phase(torch.device("cuda", 0), smi, torch.Generator().manual_seed(cs.SEED),
                         counters, out_dir=os.path.join("chiprun_out", "amp_faults", fault))
        except SystemExit as e:
            cs.log(f"  fault {fault}: phase 19 stops: {e}")
        finally:
            undo()
            torch.cuda.empty_cache()
        cs.log(f"  fault {fault} took {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
