"""Device times of the local attention kernels (the forward, K1, and the
backward's query and key sides, K2) at the stage shapes of three training
steps: AFF-Mini and AFF-Small at 512x512, batch 8 (neighbourhoods of 6
clusters of 8: 48 slots), and AFF-Base-384 at 512x1024, batch 2 (6 clusters
of 24: 144 slots).  Geometry: a regular grid per stage, clustered along the
space-filling curve, each query's 6 nearest clusters; operands from a
seeded normal draw.

    python3 autofocusformermod_torch/tools/bench_local_attn.py [--root DIR] [--iters 20]

``--root`` imports the port (and builds its kernels) from another checkout
of the repository, so that two revisions are timed on one card: run the
script once per checkout, alternating.  A shape the revision's kernels
refuse is reported as refused.  Prints the card
(``nvidia-smi --query-gpu=name,power.limit``) and one JSON line per
(model, stage) with each kernel's median ms over ``--iters`` calls
enqueued back to back behind a long matrix product (the card's time, not
the host's), then the per-step sums (a call per block).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# (heads per stage, width per stage, depth per stage, cluster size, batch,
# canvas (h, w)); the first stage has a token per 4x4 pixels, each next a
# quarter of the last
MODELS = {
    "aff_mini": ((2, 4, 8, 16), (32, 128, 256, 384), (2, 2, 6, 2), 8, 8, (512, 512)),
    "aff_small": ((3, 6, 12, 24), (96, 192, 384, 768), (3, 4, 18, 2), 8, 8, (512, 512)),
    "aff_base_384": ((4, 8, 16, 32), (128, 256, 512, 1024), (3, 4, 18, 2), 24, 2, (512, 1024)),
}
NNC = 6


def queued_ms(torch, fn, iters):
    """Median over 3 runs of the card's ms per call, the calls enqueued behind
    one long matrix product so that the host's launch work overlaps it."""
    fn()
    filler = torch.empty((8192, 8192), device="cuda")
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.matmul(filler, filler)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def stage_operands(torch, model, s, dev, gen):
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.knn import knn

    heads, dims, _, span, b, (h, w) = MODELS[model]
    hs, ws, step = h // 4 >> s, w // 4 >> s, 1 << s
    ys, xs = torch.meshgrid(torch.arange(hs), torch.arange(ws), indexing="ij")
    grid = (torch.stack([xs, ys], -1).reshape(1, -1, 2).float() * step).to(dev)
    pos, means, _, _, _ = space_filling_cluster(grid, span, h // 4, w // 4)
    n = pos.shape[1]
    nc = knn(pos, means, NNC).expand(b, n, NNC).contiguous()
    pos = pos.expand(b, n, 2).contiguous()
    nh, c_ = heads[s], dims[s] // heads[s]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    q, k, v = randn(b, nh, n, c_, scale=c_ ** -0.5), randn(b, nh, n, c_), randn(b, nh, n, c_)
    w5, b5, bk = randn(nh, 5, scale=0.1), randn(nh, scale=0.1), randn(nh, c_, scale=c_ ** -0.5)
    g = randn(b, nh, n, c_)
    return q, k, v, pos, nc, w5, b5, bk, g, span


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_local_attn: needs a CUDA device")
    from autofocusformermod_torch.ops import local_attn as la

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"root {Path(la.__file__).resolve().parents[2]}", flush=True)
    dev, gen = torch.device("cuda", 0), torch.Generator().manual_seed(0)
    for model, (_, _, depths, *_rest) in MODELS.items():
        step = {"forward": 0.0, "query_side": 0.0, "key_side": 0.0}
        for s in range(4):
            q, k, v, pos, nc, w5, b5, bk, g, span = stage_operands(torch, model, s, dev, gen)
            row = {"model": model, "stage": s + 1, "q": list(q.shape), "slots": NNC * span}
            try:
                out, blank, lse = la.local_attn_forward(q, k, v, pos, nc, w5, b5, bk, span)
            except RuntimeError as e:
                print(json.dumps({**row, "refused": str(e)[:200]}), flush=True)
                step = None
                break
            delta = (g * out).sum(-1, keepdim=True).contiguous()
            rev = la.build_reverse_lists(nc, q.shape[2], span)
            _, _, p, ds = la.backward_query_side(q, k, v, pos, nc, w5, b5, g, lse, delta, span)
            row.update(
                forward=queued_ms(torch, lambda: la.local_attn_forward(
                    q, k, v, pos, nc, w5, b5, bk, span), args.iters),
                query_side=queued_ms(torch, lambda: la.backward_query_side(
                    q, k, v, pos, nc, w5, b5, g, lse, delta, span), args.iters),
                key_side=queued_ms(torch, lambda: la.backward_key_side(
                    q, g, p, ds, rev, NNC, span), args.iters))
            for key in step:
                step[key] += depths[s] * row[key]
            print(json.dumps(row), flush=True)
            del q, k, v, g, out, blank, lse, delta, rev, p, ds
            torch.cuda.empty_cache()
        if step is not None:
            print(json.dumps({"model": model, "per_step_ms": step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
