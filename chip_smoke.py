#!/usr/bin/env python3
"""Drive the PyTorch port's semantic-segmentation paths -- AFF-Mini inference,
the AFF-Mini training step and an AFF-Small training run with checkpoint and
resume -- on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels (csrc/) with nvcc, one process per
   source;
2. holds each inference kernel against its plain PyTorch version on the
   card, at the shapes a 512x512 batch-4 forward gives it, and times both;
3. runs the full AFF-Mini + Mask2Former forward (published ADE20K widths,
   seeded random weights) at 512x512, batch 4, through the kernels, checks
   that every kernel launched the expected number of times, and compares the
   outputs with the same model run through the plain versions;
4. serves 8 random uint8 512x512 images through the predictor at batch 1
   and batch 4 and checks the label maps;
5. holds every kernel of a training step against its plain version at the
   shapes a 512x512 batch-8 step of each trained model gives it, and times
   both: local_attn forward and backward at AFF-Mini's and at AFF-Small's
   stage shapes, and what is the same for both models at one batch
   (msdetrpc forward and backward, knn, point_sample forward and backward,
   the lapjv matcher);
6. trains: the full-width AFF-Mini step (batch 8, 512x512, 100 target slots,
   12544 points, fp32, the default criterion with the nearest-tap ranking)
   on seeded synthetic label maps, once through the kernels and once
   through the plain versions from the same weights, batch and generator
   (loss terms, valid-target matches, gradient norms per parameter group),
   then 3 steps through the kernels with the launch counts of every kernel,
   ms per step for both paths and peak memory;
7. holds the two nearest-read kernels of the point ranking against their
   plain versions (exact equality: they copy floats) at the step's shapes,
   times them beside one flat torch.gather, and checks that the whole
   sampler picks identical points through kernels and plain versions on
   both routes (y-stratified, and i.i.d. with stratification off);
8. trains AFF-Small at its published width and depth (DropPath 0.3, layer
   scale 1e-5) through the package's command line, in this process: 4
   steps at batch 8 in one go; 3 steps, then a fresh Trainer that resumes
   from the checkpoint and takes the 4th; one more resumed step with
   stratification off.  Checks the resumed state (model, optimizer,
   schedule, generators: bit for bit) and step against the uninterrupted
   run, the launch counts per step, that DropPath dropped samples and that
   every parameter got a gradient, and one step at batch 2 through the
   kernels against the plain versions (loss terms and gradient norms per
   parameter group).

Exits non-zero on any failure, and at once when no CUDA device is present.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that lists the kernels with
their errors, times, launch counts, bounds and (where one PyTorch call
computes the same function) that call's time; a kernel held at the shapes of
several paths has each path's figures under "by_path".
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SIZE, BATCH, SEED = 512, 4, 0
TRAIN_BATCH, TRAIN_STEPS = 8, 3
SMALL_BATCH, SMALL_STEPS, SMALL_PLAIN_BATCH = 8, 4, 2
# the backbones of the two driven models: heads, widths and blocks per stage
# (AFF-Small's heads have 32 channels each, AFF-Mini's 16, 32, 32 and 24)
BACKBONES = {"aff_mini": ((2, 4, 8, 16), (32, 128, 256, 384), (2, 2, 6, 2)),
             "aff_small": ((3, 6, 12, 24), (96, 192, 384, 768), (3, 4, 18, 2))}
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# bytes/s, and fp32 operations/s outside the tensor cores (every kernel here
# is fp32 and uses none)
PEAK_BYTES_S, PEAK_FP32_S = 3.35e12, 67e12
# tolerances, fp32 throughout: the kernels sum in another order than the
# plain versions (a few ulps per output); knn and lapjv must agree exactly
LOCAL_ATTN_ATOL = 1e-4
MSDETRPC_ATOL = 1e-4
POINT_SAMPLE_ATOL = 1e-5
# gradients, error relative to the largest entry (at least 1) of each
# gradient tensor: the kernels scatter with atomics
# (run-to-run order) and the w5/b5 reductions sum ~1e6 terms in another order
GRAD_RTOL = 1e-3
# the two training steps: loss terms (relative), and gradient norms per
# parameter group (relative; a flipped near-tie in the matcher or in token
# selection moves them more than fp32 order does)
LOSS_RTOL = 1e-3
GROUP_NORM_RTOL = 2e-2
# at random initialisation many queries predict nearly the same mask, so
# near-tied matching costs flip a few valid-target matches between the two
# paths (the flipped assignments are equally good: the loss terms, which
# depend on them, still agree within LOSS_RTOL)
MATCH_AGREE_MIN = 0.9
# a resumed run against the uninterrupted one: the restored state (model,
# optimizer, schedule, generators) is equal bit for bit, but the backward
# kernels and PyTorch's index_add scatter with atomics, whose order changes
# from run to run, so the two runs' weights differ in the last bits after
# three updates and the 4th step's loss terms agree only to this (relative,
# about 17 times the most that two runs of the same steps were seen to
# differ by, 3e-5)
RESUME_RTOL = 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: float, operations: float) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) at the card's memory
    rate, or its fp32 operations at the card's peak rate, whichever is more."""
    by_bytes, by_ops = moved_bytes / PEAK_BYTES_S * 1e3, operations / PEAK_FP32_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def add_bounds(a: dict, b: dict, times: int = 1) -> dict:
    """Sum of two bounds' times (calls run one after the other); bound_by is
    that of the larger share."""
    if not a:
        return {"bound_ms": times * b["bound_ms"], "bound_by": b["bound_by"]}
    ms = a["bound_ms"] + times * b["bound_ms"]
    by = a["bound_by"] if a["bound_ms"] >= times * b["bound_ms"] else b["bound_by"]
    return {"bound_ms": ms, "bound_by": by}


def grid_pos(side: int, step: int, b: int, dev):
    import torch

    ys, xs = torch.meshgrid(torch.arange(side), torch.arange(side), indexing="ij")
    pos = torch.stack([xs, ys], -1).reshape(1, -1, 2).float() * step
    return pos.expand(b, -1, -1).contiguous().to(dev)


def check_knn(dev, gen, batch):
    """Every knn shape of one forward at this batch (the same for both
    models); indices and distances must be identical."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.knn import _knn_cuda, knn_plain

    cases = []   # (label, query, database, k)
    for s in range(4):                                  # backbone cluster neighbours
        b = 1 if s == 0 else batch                      # stage 1 runs on the constant grid
        pos, means, _, _, _ = space_filling_cluster(grid_pos(128 >> s, 1 << s, b, dev), 8, 128, 128)
        cases.append((f"cluster_s{s + 1}", pos, means, 6))
    for s in (1, 2):                                    # ClusterMerging 1-NN distance
        p = grid_pos(128 >> s, 1 << s, batch, dev)
        cases.append((f"merge_s{s + 1}", p, p, 2))
    q = grid_pos(128, 1, batch, dev)
    for lvl in (3, 2, 1):                               # pixel-decoder 4-NN tables, FPN
        cases.append((f"table_{128 >> lvl}", q, grid_pos(128 >> lvl, 1 << lvl, batch, dev), 4))
    cases.append(("fpn_shepard", q, grid_pos(64, 2, batch, dev), 4))
    # exact ties: integer queries exactly between half-integer database points
    cases.append(("tie_half_integer", q, grid_pos(64, 2, batch, dev) + 0.5, 4))

    ms, plain_ms, bnd = 0.0, 0.0, {}
    for label, query, db, k in cases:
        perm = torch.randperm(db.shape[1], generator=gen).to(dev)   # tie order by index
        db = db[:, perm].contiguous()
        query = query.contiguous()
        idx, d2 = _knn_cuda(query, db, k)
        ridx, rd2 = knn_plain(query, db, k)
        torch.cuda.synchronize()
        same = torch.equal(idx, ridx) and torch.equal(d2, rd2)
        t_k = cuda_ms(lambda: _knn_cuda(query, db, k))
        t_p = cuda_ms(lambda: knn_plain(query, db, k), iters=5, warmup=1)
        if label != "tie_half_integer":
            ms, plain_ms = ms + t_k, plain_ms + t_p
            # 5 operations per (query, database point) pair: two differences,
            # two squares, a sum; the selection's comparisons not counted
            pairs = query.shape[0] * query.shape[1] * db.shape[1]
            bnd = add_bounds(bnd, bound(nbytes(query, db, idx, d2), 5 * pairs))
        log(f"  knn b{batch} {label:18s} q={tuple(query.shape)} db={tuple(db.shape)} k={k}: "
            f"identical={same} kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        if not same:
            raise SystemExit(f"knn b{batch} {label}: kernel and plain version disagree")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bnd}


def knn_record(paths: dict) -> dict:
    return {"name": "knn", "route": "cuda", "source": "autofocusformermod_torch/csrc/knn.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/knn_kernel.py:136",
            "library_ms": None, **per_path(paths, "b4_forward")}


def per_path(paths: dict, first: str) -> dict:
    """The keys of a kernel record whose kernel is held at the shapes of
    several driven paths: the times and bound are those of the path `first`
    (the one every earlier record of this kernel gave), the error is the
    worst of all, and `by_path` has each path's own figures."""
    return {"max_abs_err": max(r["max_abs_err"] for r in paths.values()),
            **{k: paths[first][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "by_path": paths}


def check_local_attn(dev, gen, model, b):
    """K1 at the four backbone stages' shapes of `model` at batch b; ms sums
    the calls of one forward (one per block)."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import sfc_cluster_attention

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    heads, dims, depths = BACKBONES[model]
    err, ms, plain_ms, bnd = 0.0, 0.0, 0.0, {}
    for s in range(4):
        h, c_ = heads[s], dims[s] // heads[s]
        pos, means, _, _, _ = space_filling_cluster(grid_pos(128 >> s, 1 << s, 1, dev), 8, 128, 128)
        n = pos.shape[1]
        nc = knn(pos, means, 6).expand(b, n, 6).contiguous()
        pos = pos.expand(b, n, 2).contiguous()
        q = randn(b, h, n, c_, scale=c_ ** -0.5)
        k, v = randn(b, h, n, c_), randn(b, h, n, c_)
        w5, b5, bk = randn(h, 5, scale=0.1), randn(h, scale=0.1), randn(h, c_, scale=c_ ** -0.5)
        args = (q, k, v, pos, nc, w5, b5, bk, 8)
        out, blank = sfc_cluster_attention(*args)
        with plain_versions():
            rout, rblank = sfc_cluster_attention(*args)
            t_p = cuda_ms(lambda: sfc_cluster_attention(*args), iters=5, warmup=1)
        t_k = cuda_ms(lambda: sfc_cluster_attention(*args))
        e = max((out - rout).abs().max().item(), (blank - rblank).abs().max().item())
        err = max(err, e)
        ms, plain_ms = ms + depths[s] * t_k, plain_ms + depths[s] * t_p
        # per (query, head, neighbour): q.k and p.v (4 c_) and the 5-feature
        # rel-pos bias (10); lse is the third output
        bnd = add_bounds(bnd, bound(nbytes(q, k, v, pos, nc, w5, b5, bk, out, blank, blank),
                                    b * h * n * 48 * (4 * c_ + 10)), depths[s])
        log(f"  local_attn {model} b{b} stage {s + 1} q={tuple(q.shape)} nnc*span=48: max_abs_err "
            f"{e:.3e} (rel {e / rout.abs().max().item():.3e}) kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms")
        del q, k, v, out, blank, rout, rblank, args
        torch.cuda.empty_cache()
    if not err <= LOCAL_ATTN_ATOL:
        raise SystemExit(f"local_attn {model} b{b}: max abs err {err} > {LOCAL_ATTN_ATOL}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd}


def local_attn_record(paths: dict) -> dict:
    return {"name": "local_attn", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/local_attn.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/local_attn.py:756",
            "library_ms": None, **per_path(paths, "aff_mini_b4_forward")}


def check_msdetrpc(dev, gen, b):
    """K3 at batch b (bh = 8 b; the pixel decoder is the same for both
    models): 3 levels x 16 pairs, c_=32 at the three query levels; ms sums
    the 18 calls of a forward (6 encoder layers x 3 levels)."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.msdetrpc import msdetrpc_levels_s

    bh, p, c_, sizes = b * 8, 16, 32, (256, 1024, 4096)
    val = torch.randn((bh, sum(sizes), c_), generator=gen).to(dev)
    err, ms, plain_ms, bnd = 0.0, 0.0, 0.0, {}
    for n in sizes:
        idx = torch.cat([torch.randint(0, s, (bh, n, p), generator=gen) for s in sizes], 2)
        w = torch.rand((bh, n, 3 * p), generator=gen)
        idx = idx.int().to(dev).contiguous()
        w = (w / w.sum(-1, keepdim=True)).to(dev).contiguous()
        out = msdetrpc_levels_s(idx, w, val, sizes)
        with plain_versions():
            ref = msdetrpc_levels_s(idx, w, val, sizes)
            t_p = cuda_ms(lambda: msdetrpc_levels_s(idx, w, val, sizes), iters=5, warmup=1)
        t_k = cuda_ms(lambda: msdetrpc_levels_s(idx, w, val, sizes))
        e = (out - ref).abs().max().item()
        err = max(err, e)
        ms, plain_ms = ms + 6 * t_k, plain_ms + 6 * t_p
        # a multiply and an add per (query, pair, channel)
        bnd = add_bounds(bnd, bound(nbytes(idx, w, val, out), 2 * bh * n * 3 * p * c_), 6)
        log(f"  msdetrpc b{b} n={n} idx={tuple(idx.shape)} val={tuple(val.shape)}: max_abs_err "
            f"{e:.3e} (rel {e / ref.abs().max().item():.3e}) kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms")
    if not err <= MSDETRPC_ATOL:
        raise SystemExit(f"msdetrpc b{b}: max abs err {err} > {MSDETRPC_ATOL}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd}


def msdetrpc_record(paths: dict) -> dict:
    return {"name": "msdetrpc", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/msdetrpc.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:2061",
            "library_ms": None, **per_path(paths, "b4_forward")}


def grad_errs(got, want):
    """(max abs err, max abs err / max(max |ref|, 1)) over pairs of gradients."""
    errs = [((a - r).abs().max().item(), max(r.abs().max().item(), 1.0))
            for a, r in zip(got, want)]
    return max(e for e, _ in errs), max(e / s for e, s in errs)


def plain_grad_ms(fn, inputs, cots) -> float:
    """Device ms of the plain version's autograd backward alone."""
    import torch

    from autofocusformermod_torch.ops.dispatch import plain_versions

    with plain_versions():
        outs = fn()
    outs = outs if isinstance(outs, tuple) else (outs,)
    return cuda_ms(lambda: torch.autograd.grad(outs, inputs, cots, retain_graph=True),
                   iters=5, warmup=1)


def check_local_attn_bwd(dev, gen, model, b):
    """K2 at the four stages' shapes of a batch-b step of `model`: the
    gradients of the kernel pair against the plain version's autograd; ms
    sums the backward calls of a step, one per block (the kernel backward
    alone vs the plain version's autograd backward alone)."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import (
        local_attn_forward, sfc_cluster_attention, sfc_cluster_attention_backward)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    heads, dims, depths = BACKBONES[model]
    err, worst, ms, plain_ms, bnd = 0.0, 0.0, 0.0, 0.0, {}
    for s in range(4):
        h, c_ = heads[s], dims[s] // heads[s]
        pos, means, _, _, _ = space_filling_cluster(grid_pos(128 >> s, 1 << s, 1, dev), 8, 128, 128)
        n = pos.shape[1]
        nc = knn(pos, means, 6).expand(b, n, 6).contiguous()
        pos = pos.expand(b, n, 2).contiguous()
        diff = [randn(b, h, n, c_, scale=c_ ** -0.5), randn(b, h, n, c_), randn(b, h, n, c_),
                randn(h, 5, scale=0.1), randn(h, scale=0.1), randn(h, c_, scale=c_ ** -0.5)]
        g, gb = randn(b, h, n, c_), randn(b, h, n, 1)
        leaves = [t.clone().requires_grad_() for t in diff]

        def fwd():
            q, k, v, w5, b5, bk = leaves
            return sfc_cluster_attention(q, k, v, pos, nc, w5, b5, bk, 8)

        got = torch.autograd.grad(fwd(), leaves, (g, gb))
        with plain_versions():
            want = torch.autograd.grad(fwd(), leaves, (g, gb))
        e, rel = grad_errs(got, want)
        err, worst = max(err, e), max(worst, rel)
        q, k, v, w5, b5, bk = diff
        out, blank, lse = local_attn_forward(q, k, v, pos, nc, w5, b5, bk, 8)
        delta = ((g * out).sum(-1, keepdim=True) + gb * blank).contiguous()
        t_k = cuda_ms(lambda: sfc_cluster_attention_backward(q, k, v, pos, nc, w5, b5, g, lse,
                                                             delta, 8))
        t_p = plain_grad_ms(fwd, leaves, (g, gb))
        ms, plain_ms = ms + depths[s] * t_k, plain_ms + depths[s] * t_p
        # per (query, head, neighbour): q.k again, g.v, and the three
        # products into dq, dk, dv (10 c_), and the bias and its gradient (20);
        # out: dq, dk, dv and the per-query rel-pos partials (5 per head)
        bnd = add_bounds(bnd, bound(nbytes(q, k, v, pos, nc, w5, b5, g, lse, delta, q, k, v)
                                    + 4 * b * h * n * 5,
                                    b * h * n * 48 * (10 * c_ + 20)), depths[s])
        log(f"  local_attn bwd {model} b{b} stage {s + 1} q={tuple(q.shape)}: max_abs_err {e:.3e} "
            f"(rel {rel:.3e}; dq dk dv dw5 db5 dblank_k) kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        del diff, leaves, got, want, q, k, v, g, gb, out, blank, lse, delta
        torch.cuda.empty_cache()
    if not worst <= GRAD_RTOL:
        raise SystemExit(f"local_attn backward {model} b{b}: max rel err {worst} > {GRAD_RTOL}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd}


def local_attn_bwd_record(paths: dict) -> dict:
    return {"name": "local_attn_bwd", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/local_attn.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/local_attn.py:622",
            "library_ms": None, **per_path(paths, f"aff_mini_b{TRAIN_BATCH}_step")}


def check_msdetrpc_bwd(dev, gen):
    """K4 at a batch-8 step's shapes (bh=64, 3 levels x 16 pairs, c_=32);
    ms sums the 18 backward calls of a step."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.msdetrpc import (
        msdetrpc_levels_s, msdetrpc_levels_s_backward)

    bh, p, c_, sizes = TRAIN_BATCH * 8, 16, 32, (256, 1024, 4096)
    val = torch.randn((bh, sum(sizes), c_), generator=gen).to(dev)
    err, worst, ms, plain_ms, bnd = 0.0, 0.0, 0.0, 0.0, {}
    for n in sizes:
        idx = torch.cat([torch.randint(0, s, (bh, n, p), generator=gen) for s in sizes], 2)
        idx = idx.int().to(dev).contiguous()
        w = torch.rand((bh, n, 3 * p), generator=gen)
        w = (w / w.sum(-1, keepdim=True)).to(dev).contiguous()
        g = torch.randn((bh, n, c_), generator=gen).to(dev)
        leaves = [w.clone().requires_grad_(), val.clone().requires_grad_()]

        def fwd():
            return msdetrpc_levels_s(idx, leaves[0], leaves[1], sizes)

        got = torch.autograd.grad(fwd(), leaves, g)
        with plain_versions():
            want = torch.autograd.grad(fwd(), leaves, g)
        e, rel = grad_errs(got, want)
        err, worst = max(err, e), max(worst, rel)
        t_k = cuda_ms(lambda: msdetrpc_levels_s_backward(idx, w, val, g, sizes))
        t_p = plain_grad_ms(fwd, leaves, g)
        ms, plain_ms = ms + 6 * t_k, plain_ms + 6 * t_p
        # d_val += w * g and d_w = g . val: 4 operations per (query, pair, channel)
        bnd = add_bounds(bnd, bound(nbytes(idx, w, val, g, w, val), 4 * bh * n * 3 * p * c_), 6)
        log(f"  msdetrpc bwd n={n} idx={tuple(idx.shape)} val={tuple(val.shape)}: max_abs_err "
            f"{e:.3e} (rel {rel:.3e}; d_w d_val) kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    if not worst <= GRAD_RTOL:
        raise SystemExit(f"msdetrpc backward: max rel err {worst} > {GRAD_RTOL}")
    return {"name": "msdetrpc_bwd", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/msdetrpc.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:2078",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **bnd}


def check_point_sample(dev, gen):
    """K10 at a batch-8 step's calls: the target labels (800 512x512 masks x
    10 x 12544 points), the matched logits (8000 x 12544) and the one
    backward (the logits'); ms sums the three.  The ranking read of the
    reference sampler (8000 masks x 37632 candidates), which the default
    criterion no longer makes, is held and timed too but not summed.  The
    library call is F.grid_sample on the same masks and points."""
    import torch
    import torch.nn.functional as F
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.point_sample import (
        point_sample_backward, point_sample_bilinear)

    def grid_sample(m, grid):
        return F.grid_sample(m[:, None], grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    n_t, layers, pts = TRAIN_BATCH * 100, 10, 12544
    masks = torch.randn((layers * n_t, 128, 128), generator=gen).to(dev) * 3
    cases = (("ranking", masks, (layers * n_t, 3 * pts)),
             ("targets", None, (n_t, layers * pts)),
             ("logits", masks, (layers * n_t, pts)))
    fwd_err, bwd_err, bwd_rel, ms, plain_ms, lib_ms, bnd = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, {}
    for label, m, (n, p) in cases:
        if m is None:
            m = (torch.rand((n, SIZE, SIZE), generator=gen) < 0.3).float().to(dev)
        coords = torch.rand((n, p, 2), generator=gen).to(dev)
        out = point_sample_bilinear(m, coords)
        with plain_versions():
            ref = point_sample_bilinear(m, coords)
            t_p = cuda_ms(lambda: point_sample_bilinear(m, coords), iters=3, warmup=1)
        t_k = cuda_ms(lambda: point_sample_bilinear(m, coords), iters=5, warmup=1)
        grid = (coords * 2 - 1)[:, None]
        lib = grid_sample(m, grid)[:, 0, 0]
        t_l = cuda_ms(lambda: grid_sample(m, grid), iters=5, warmup=1)
        e = (out - ref).abs().max().item()
        e_lib = (lib - ref).abs().max().item()
        fwd_err = max(fwd_err, e)
        on_path = label != "ranking"
        if on_path:
            ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
            # per point: the pixel coordinate, four weights and the blend, ~20
            bnd = add_bounds(bnd, bound(nbytes(m, coords, out), 20 * n * p))
        log(f"  point_sample fwd {label:8s} masks={tuple(m.shape)} points={p}: max_abs_err "
            f"{e:.3e} kernel {t_k:.4f} ms, plain {t_p:.4f} ms, grid_sample {t_l:.4f} ms "
            f"(its err vs plain {e_lib:.3e}){'' if on_path else ' [not on the default path]'}")
        del out, ref, lib
        if label == "logits":
            g = torch.randn((n, p), generator=gen).to(dev)
            leaf = m.clone().requires_grad_()
            got = torch.autograd.grad(point_sample_bilinear(leaf, coords), leaf, g)[0]
            with plain_versions():
                want = torch.autograd.grad(point_sample_bilinear(leaf, coords), leaf, g)[0]
            bwd_err, bwd_rel = grad_errs([got], [want])
            t_k = cuda_ms(lambda: point_sample_backward(coords, g, tuple(m.shape)), iters=5,
                          warmup=1)
            t_p = plain_grad_ms(lambda: point_sample_bilinear(leaf, coords), [leaf], g)
            lib_out = grid_sample(leaf, grid)
            t_l = cuda_ms(lambda: torch.autograd.grad(lib_out, leaf, g[:, None, None],
                                                      retain_graph=True), iters=5, warmup=1)
            ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
            bnd = add_bounds(bnd, bound(nbytes(coords, g, m), 20 * n * p))
            log(f"  point_sample bwd {label:8s}: max_abs_err {bwd_err:.3e} (rel {bwd_rel:.3e}) "
                f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, grid_sample's backward {t_l:.4f} ms")
            del got, want, leaf, lib_out
        del coords, grid
        torch.cuda.empty_cache()
    if not (fwd_err <= POINT_SAMPLE_ATOL and bwd_rel <= GRAD_RTOL):
        raise SystemExit(f"point_sample: forward err {fwd_err} > {POINT_SAMPLE_ATOL} or "
                         f"backward rel err {bwd_rel} > {GRAD_RTOL}")
    return {"name": "point_sample", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/point_sample.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/point_sample_kernel.py:200",
            "max_abs_err": max(fwd_err, bwd_err), "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **bnd}


def check_lapjv(dev, gen):
    """K13 on a step's stacked problems: 10 layers x 8 images, 100 queries x
    100 target slots, 8-12 valid targets per image (the rest at the 1e8
    sentinel).  The assignments must be identical."""
    import torch
    from autofocusformermod_torch.losses.lapjv import hungarian_lsap, lapjv

    b = 10 * TRAIN_BATCH
    cost = torch.rand((b, 100, 100), generator=gen) * 10 - 5
    n_valid = torch.randint(8, 13, (b,), generator=gen)
    cost = torch.where(torch.arange(100)[None, None] < n_valid[:, None, None], cost, 1e8)
    cost = cost.to(dev)
    got = lapjv(cost)
    ref = hungarian_lsap(cost)
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    t_k = cuda_ms(lambda: lapjv(cost), iters=5, warmup=1)
    t_p = cuda_ms(lambda: hungarian_lsap(cost), iters=2, warmup=1)
    log(f"  lapjv cost={tuple(cost.shape)}: identical={same} kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms")
    if not same:
        raise SystemExit("lapjv: kernel and plain version disagree")
    return {"name": "lapjv", "route": "cuda", "source": "autofocusformermod_torch/csrc/lapjv.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/lapjv_kernel.py:161",
            "max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p, "library_ms": None,
            # every cost read and reduced at least once (a comparison and a
            # subtraction); the solver's sequential augmenting steps, which
            # set its real time, are in neither term
            **bound(nbytes(cost, got), 2 * cost.numel())}


def check_nearest(dev, gen):
    """K11 and K12 at a batch-8 step's ranking shapes (8000 masks of 128x128,
    37632 candidates each = 294 chunks of 128): the kernels copy floats, so
    they must equal their plain versions exactly.  The library call is one
    flat torch.gather on a precomputed cell index."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.point_sample import (point_sample_nearest,
                                                           point_sample_nearest_rows)

    n, h, w, p = 10 * TRAIN_BATCH * 100, 128, 128, 3 * 12544
    chunks = p // 128
    masks = torch.randn((n, h, w), generator=gen).to(dev) * 3
    flat = masks.reshape(n, h * w)
    records = []

    def hold(name, line, fn, args, cell_index):
        out = fn(masks, *args)
        with plain_versions():
            ref = fn(masks, *args)
            t_p = cuda_ms(lambda: fn(masks, *args), iters=3, warmup=1)
        t_k = cuda_ms(lambda: fn(masks, *args), iters=10, warmup=2)
        lib = torch.gather(flat, 1, cell_index)
        t_l = cuda_ms(lambda: torch.gather(flat, 1, cell_index), iters=10, warmup=2)
        same = torch.equal(out, ref) and torch.equal(lib.reshape(out.shape), ref)
        bnd = bound(nbytes(masks, *args, out), 6 * out.numel())
        log(f"  {name} masks={tuple(masks.shape)} candidates={p}: identical={same} kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, torch.gather {t_l:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        if not same:
            raise SystemExit(f"{name}: kernel, plain version and torch.gather disagree")
        records.append({"name": name, "route": "cuda",
                        "source": "autofocusformermod_torch/csrc/point_sample.cu",
                        "replaces": f"autofocusformermod_tpu/ops/pallas/point_sample_kernel.py:{line}",
                        "max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p, "library_ms": t_l, **bnd})

    coords = torch.rand((n, p, 2), generator=gen).to(dev)
    cell = ((coords[..., 1] * h).int().clamp(0, h - 1) * w
            + (coords[..., 0] * w).int().clamp(0, w - 1)).long()
    hold("point_sample_nearest", 266, point_sample_nearest, (coords,), cell)
    del coords, cell
    u = torch.rand((n, chunks, 128), generator=gen).to(dev)
    ys = (torch.arange(chunks, device=dev)[None, :, None] + u) * (1.0 / chunks)
    cy = (ys * h).int().clamp(0, h - 1)
    cx = (torch.rand((n, chunks, 128), generator=gen).to(dev) * w).int().clamp(0, w - 1)
    del u, ys
    hold("point_sample_nearest_rows", 344, point_sample_nearest_rows, (cx, cy),
         (cy * w + cx).long().reshape(n, p))
    return records


def check_sampler(dev, gen):
    """The whole nearest-tap sampler at the step's shapes, through the kernels
    and through the plain versions from the same seeds: the picked
    coordinates must be identical, on the stratified route and with
    stratification off.  Times the sampler, and its top-k alone."""
    import torch
    from autofocusformermod_torch.losses import point_sample as sampler
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.gather import topk_indices

    n, pts = 10 * TRAIN_BATCH * 100, 12544
    masks = torch.randn((n, 128, 128), generator=gen).to(dev) * 3

    def run():
        draw = device_draw(torch.Generator(device=dev).manual_seed(SEED))
        return sampler.get_uncertain_point_coords_nn_ranked(draw, masks, pts, 3.0, 0.75)

    try:
        for stratify in (True, False):
            sampler.STRATIFY_RANKING = stratify
            got = run()
            with plain_versions():
                want = run()
            same = torch.equal(got, want)
            # a stratified y may round up to exactly 1, as in the JAX package
            ok = (tuple(got.shape) == (n, pts, 2) and bool((got >= 0).all())
                  and bool((got <= 1).all()))
            t = cuda_ms(run, iters=3, warmup=1)
            log(f"  sampler, stratified={stratify}: picked coordinates identical={same}, in "
                f"[0, 1]={ok}, {t:.3f} ms")
            if not (same and ok):
                raise SystemExit(f"sampler (stratified={stratify}): kernel and plain version "
                                 "pick different points, or points outside the image")
            del got, want
    finally:
        sampler.STRATIFY_RANKING = True
    del masks
    unc = torch.randn((n * 294, 128), device=dev)
    t_rows = cuda_ms(lambda: topk_indices(unc, 32), iters=3, warmup=1)
    wide = unc.reshape(n, 3 * pts)
    t_wide = cuda_ms(lambda: topk_indices(wide, int(0.75 * pts)), iters=3, warmup=1)
    t_topk = cuda_ms(lambda: torch.topk(wide, int(0.75 * pts), dim=1), iters=3, warmup=1)
    log(f"  lowest-index top-k (stable sort): 32 of 128 over {unc.shape[0]} rows {t_rows:.3f} ms;"
        f" 9408 of 37632 over {n} rows {t_wide:.3f} ms (torch.topk, other tie order: "
        f"{t_topk:.3f} ms)")


def kept_agreement(fk, fp):
    """Per stage after res2: share of kept token positions common to both runs."""
    import torch

    out = {}
    for i in (3, 4, 5):
        a, b = fk[f"res{i}_pos"], fp[f"res{i}_pos"]
        ida = (a[..., 1] * 4096 + a[..., 0]).long()
        idb = (b[..., 1] * 4096 + b[..., 0]).long()
        out[f"res{i}"] = torch.stack([torch.isin(ida[j], idb[j]).float().mean()
                                      for j in range(a.shape[0])]).mean().item()
    return out


def group_norms(model):
    """Gradient norm of each optimizer parameter group."""
    import torch
    from autofocusformermod_torch.engine.optimizer import param_groups

    return {label: torch.sqrt(sum((p.grad ** 2).sum() for _, p in named)).item()
            for label, named in param_groups(model).items()}


def train_phase(dev, smi, counters):
    """Phase 6.  Returns {counter name: launches over the TRAIN_STEPS steps}."""
    import contextlib
    import copy

    import torch
    from autofocusformermod_torch.config import aff_mini_cfg
    from autofocusformermod_torch.data.synthetic import synthetic_batch
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config
    from autofocusformermod_torch.ops.dispatch import plain_versions

    cfg = aff_mini_cfg()
    model = maskformer_from_config(cfg)
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    initial = copy.deepcopy(model.state_dict())
    batch = synthetic_batch(torch.Generator().manual_seed(SEED + 1), dev, TRAIN_BATCH,
                            (SIZE, SIZE), cfg.TPU.MAX_GT_INSTANCES,
                            cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    n_valid = batch["valid"].sum(1).tolist()
    log(f"  batch {TRAIN_BATCH} x {SIZE}x{SIZE}, {cfg.TPU.MAX_GT_INSTANCES} target slots, "
        f"valid targets per image {n_valid}")

    def draw():
        return device_draw(torch.Generator(device=dev).manual_seed(SEED))

    def grads_of(path):
        """Forward, criterion and backward from the initial weights."""
        model.load_state_dict(initial)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with path():
            total, losses, matched = TrainStep(model, cfg).loss_and_grads(batch, draw())
        torch.cuda.synchronize()
        dt = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        return total, losses, matched, grads, group_norms(model), dt, peak

    k_total, k_losses, k_matched, k_grads, k_norms, k_dt, k_peak = grads_of(contextlib.nullcontext)
    p_total, p_losses, p_matched, p_grads, p_norms, p_dt, p_peak = grads_of(plain_versions)
    log(f"  forward + criterion + backward: kernels {k_dt:.3f} s (peak {k_peak:.2f} GiB), "
        f"plain versions {p_dt:.3f} s (peak {p_peak:.2f} GiB) [first call of each]")
    bad = [k for k, v in k_losses.items() if not torch.isfinite(v)]
    if bad or not torch.isfinite(k_total):
        raise SystemExit(f"non-finite losses: {bad}")
    worst = max(abs(k_losses[k].item() - p_losses[k].item()) / max(abs(p_losses[k].item()), 1e-6)
                for k in k_losses)
    log(f"  total loss kernels {k_total.item():.6f} plain {p_total.item():.6f}; "
        f"{len(k_losses)} loss terms, worst rel diff {worst:.3e}")
    valid = batch["valid"]
    agree = torch.stack([(a == b)[valid].float().mean() for a, b in zip(k_matched, p_matched)])
    log(f"  valid-target matches equal in {agree.mean().item() * 100:.2f}% "
        f"(per layer min {agree.min().item() * 100:.2f}%)")
    group_diff = {g: abs(k_norms[g] - p_norms[g]) / max(p_norms[g], 1e-12) for g in p_norms}
    log("  grad norm per group (kernels / plain): " + ", ".join(
        f"{g} {k_norms[g]:.5g}/{p_norms[g]:.5g}" for g in sorted(p_norms)))
    missing = [n for n, g in p_grads.items() if g.abs().max() > 0 and not k_grads[n].abs().max() > 0]
    log(f"  parameters with a gradient: plain {sum(g.abs().max().item() > 0 for g in p_grads.values())}"
        f" of {len(p_grads)}; of those, zero through the kernels: {len(missing)}")
    if missing:
        raise SystemExit(f"the kernel step gives no gradient to {missing[:10]}")
    if worst > LOSS_RTOL:
        raise SystemExit(f"loss terms: kernels and plain versions differ by {worst} (rel)")
    if max(group_diff.values()) > GROUP_NORM_RTOL:
        raise SystemExit(f"gradient norms per group disagree: {group_diff}")
    if agree.mean().item() < MATCH_AGREE_MIN:
        raise SystemExit("valid-target matches disagree between kernels and plain versions")

    def timed_steps(path, n):
        """n full steps from the initial weights and a fresh optimizer."""
        model.load_state_dict(initial)
        step, gen = TrainStep(model, cfg), draw()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        with path():
            for _ in range(n):
                t0 = time.time()
                metrics.append(step(batch, gen))
                torch.cuda.synchronize()
                times.append(time.time() - t0)
        return times, metrics, torch.cuda.max_memory_allocated() / 2 ** 30

    for fn in counters.values():
        fn.launches = 0
    times, metrics, peak = timed_steps(contextlib.nullcontext, TRAIN_STEPS)
    launches = {name: fn.launches for name, fn in counters.items()}
    for i, (t, m) in enumerate(zip(times, metrics)):
        if not all(torch.isfinite(v) for v in m.values()):
            raise SystemExit(f"step {i}: non-finite metrics")
        log(f"  kernels step {i}: {t * 1e3:.1f} ms, total_loss {m['total_loss'].item():.5f} "
            f"loss_ce {m['loss_ce'].item():.5f} loss_mask {m['loss_mask'].item():.5f} "
            f"loss_dice {m['loss_dice'].item():.5f} grad_norm {m['grad_norm'].item():.5f}")
    p_times, _, p_peak = timed_steps(plain_versions, TRAIN_STEPS)
    k_ms = statistics.median(times[1:]) * 1e3
    p_ms = statistics.median(p_times[1:]) * 1e3
    log(f"  ms per step (median of steps 2-{TRAIN_STEPS}): kernels {k_ms:.1f} "
        f"({TRAIN_BATCH / k_ms * 1e3:.2f} images/s, peak {peak:.2f} GiB), plain versions {p_ms:.1f} "
        f"({TRAIN_BATCH / p_ms * 1e3:.2f} images/s, peak {p_peak:.2f} GiB) ({smi})")
    log(f"  launches over {TRAIN_STEPS} steps: {launches}")
    return launches


def same_tree(a, b) -> bool:
    """Whether two nested dicts and lists of tensors and plain values (a
    state dict) are equal, tensors bit for bit."""
    import torch

    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def small_phase(dev, smi, counters):
    """Phase 8.  Returns ({counter: launches over the SMALL_STEPS steps of the
    uninterrupted run}, {nearest-read counter: launches in the one step with
    stratification off})."""
    import contextlib
    import copy
    import json
    import os
    import tempfile

    import torch
    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.config import aff_small_cfg
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.losses import point_sample as sampler
    from autofocusformermod_torch.models.layers import DropPath
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.ops.dispatch import plain_versions

    def cli(out_dir, max_iter, resume=False):
        argv = ["--config", "aff_small", "--synthetic", "--max-iter", str(max_iter)]
        argv += ["--resume"] if resume else []
        return train_net.main(argv + ["SOLVER.IMS_PER_BATCH", str(SMALL_BATCH),
                                      "OUTPUT_DIR", out_dir])

    def small_cfg(out_dir, batch=SMALL_BATCH):
        cfg = aff_small_cfg()
        cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", str(batch), "OUTPUT_DIR", out_dir])
        return cfg

    def metrics_of(out_dir):
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            return {m["step"]: m for m in map(json.loads, f)}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def loss_terms(m):
        return {k: v for k, v in m.items() if k.startswith("loss_") or k == "total_loss"}

    def worst_rel(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in b)

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="aff_small_") as tmp:
        dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")

        # the uninterrupted run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        trainer = cli(dir_a, SMALL_STEPS)
        launches = {name: fn.launches for name, fn in counters.items()}
        whole = metrics_of(dir_a)
        cfg = trainer.cfg
        a = cfg.MODEL.AFF
        n_params = sum(p.numel() for p in trainer.model.parameters())
        log(f"  AFF-Small EMBED_DIM {a.EMBED_DIM} DEPTHS {a.DEPTHS} NUM_HEADS {a.NUM_HEADS} "
            f"MLP_RATIO {a.MLP_RATIO} DROP_PATH_RATE {a.DROP_PATH_RATE} LAYER_SCALE "
            f"{a.LAYER_SCALE}; {n_params / 1e6:.1f} M parameters")
        for step in sorted(whole):
            m = whole[step]
            if not all(v == v and abs(v) != float("inf") for v in loss_terms(m).values()):
                raise SystemExit(f"AFF-Small step {step}: non-finite loss terms")
            log(f"  step {step}: {m['seconds'] * 1e3:.1f} ms, total_loss {m['total_loss']:.5f} "
                f"loss_ce {m['loss_ce']:.5f} loss_mask {m['loss_mask']:.5f} loss_dice "
                f"{m['loss_dice']:.5f} grad_norm {m['grad_norm']:.5f}")
        if sorted(whole) != list(range(1, SMALL_STEPS + 1)):
            raise SystemExit(f"the run logged steps {sorted(whole)}")
        ms = statistics.median(whole[s]["seconds"] for s in range(2, SMALL_STEPS + 1)) * 1e3
        peak = whole[SMALL_STEPS]["peak_bytes_in_use"] / 2 ** 30
        log(f"  ms per step (median of steps 2-{SMALL_STEPS}): {ms:.1f} = "
            f"{SMALL_BATCH / ms * 1e3:.2f} images/s at batch {SMALL_BATCH}, peak {peak:.2f} GiB "
            f"({smi})")
        log(f"  launches over {SMALL_STEPS} steps: {launches}")
        # a branch that DropPath dropped for every sample of the last step has
        # no gradient in it, so ask Adam's first moment, which is nonzero
        # exactly where some step's gradient was
        moments = trainer.step_fn.optimizer.state
        no_grad = [n for n, p in trainer.model.named_parameters()
                   if not moments[p]["exp_avg"].abs().max() > 0]
        gammas = [n for n, _ in trainer.model.named_parameters() if "gamma" in n]
        log(f"  parameters that no gradient reached in {SMALL_STEPS} steps: {len(no_grad)} of "
            f"{len(moments)} ({len(gammas)} of them layer scales)")
        if no_grad or len(gammas) != 2 * sum(a.DEPTHS):
            raise SystemExit(f"no gradient reached {no_grad[:10]}")
        del trainer
        torch.cuda.empty_cache()

        # stop after 3 steps, resume in a fresh Trainer, take the 4th; count
        # the samples DropPath drops on the way
        dropped = torch.zeros((), dtype=torch.long, device=dev)

        def count_dropped(module, args, out):
            if isinstance(module, DropPath) and module.training and module.rate > 0:
                dropped.add_((out.flatten(1).abs().amax(1) == 0).sum())

        hook = torch.nn.modules.module.register_module_forward_hook(count_dropped)
        try:
            first = cli(dir_b, SMALL_STEPS - 1)
        finally:
            hook.remove()
        calls = 2 * sum(a.DEPTHS) * (SMALL_STEPS - 1) * SMALL_BATCH
        log(f"  DropPath dropped {int(dropped)} of {calls} residual branches in "
            f"{SMALL_STEPS - 1} steps")
        if not 0 < int(dropped) < calls:
            raise SystemExit("DropPath is not live in the training run")
        saved = copy.deepcopy(first.state(SMALL_STEPS - 1))
        n_moments = sum(1 for st in saved["optimizer"]["state"].values()
                        for k in ("exp_avg", "exp_avg_sq") if st[k].abs().max() > 0)
        del first
        torch.cuda.empty_cache()
        fresh = Trainer(small_cfg(dir_b), dev)
        fresh.resume_or_load(resume=True)
        restored = fresh.state(fresh.start_step)
        same = {part: same_tree(saved[part], restored[part]) for part in saved}
        log(f"  a fresh Trainer resumed at step {fresh.start_step}; equal to the stopped run's, "
            f"bit for bit: {same} ({len(saved['model'])} model tensors, {n_moments} nonzero AdamW "
            f"moments, schedule at {saved['scheduler']['last_epoch']})")
        if not all(same.values()) or fresh.start_step != SMALL_STEPS - 1 \
                or saved["scheduler"]["last_epoch"] != SMALL_STEPS - 1 or not n_moments:
            raise SystemExit(f"the resumed state differs from the stopped run's: {same}")
        del restored
        del fresh, saved
        torch.cuda.empty_cache()
        cli(dir_b, SMALL_STEPS, resume=True)
        resumed = metrics_of(dir_b)
        for step in range(1, SMALL_STEPS + 1):
            rel = worst_rel(loss_terms(resumed[step]), loss_terms(whole[step]))
            exact = loss_terms(resumed[step]) == loss_terms(whole[step])
            log(f"  step {step}{' (resumed)' if step == SMALL_STEPS else ''}: loss terms against "
                f"the uninterrupted run: worst rel diff {rel:.3e}, exactly equal: {exact}")
            if rel > RESUME_RTOL:
                raise SystemExit(f"step {step}: the two runs' loss terms differ by {rel} (rel)")

        # one more resumed step with stratification off: the i.i.d. route
        # reads through point_sample_nearest
        sampler.STRATIFY_RANKING = False
        try:
            reset_counts()
            cli(dir_b, SMALL_STEPS + 1, resume=True)
            k11 = {name: counters[name].launches
                   for name in ("point_sample_nearest", "point_sample_nearest_rows")}
        finally:
            sampler.STRATIFY_RANKING = True
        m = metrics_of(dir_b)[SMALL_STEPS + 1]
        log(f"  step {SMALL_STEPS + 1}, stratification off: {m['seconds'] * 1e3:.1f} ms, "
            f"total_loss {m['total_loss']:.5f}; launches {k11}")
        torch.cuda.empty_cache()

        # one step at a smaller batch through the kernels and through the
        # plain versions (which at the full batch need more memory than the
        # card has), from the same weights, batch and generators
        results = []
        for path in (contextlib.nullcontext, plain_versions):
            cfg_c = small_cfg(os.path.join(tmp, "c"), SMALL_PLAIN_BATCH)
            tr = Trainer(cfg_c, dev)
            batch = next(synthetic_batches(cfg_c, dev))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with path():
                total, losses, _ = tr.step_fn.loss_and_grads(batch, tr.draw)
            torch.cuda.synchronize()
            results.append(({"total_loss": total.item(),
                             **{k: v.item() for k, v in losses.items()}},
                            group_norms(tr.model),
                            torch.cuda.max_memory_allocated() / 2 ** 30))
            del tr, batch, total, losses
            torch.cuda.empty_cache()
        (k_terms, k_norms, k_peak), (p_terms, p_norms, p_peak) = results
        rel = worst_rel(k_terms, p_terms)
        log(f"  one step at batch {SMALL_PLAIN_BATCH}: total loss kernels "
            f"{k_terms['total_loss']:.6f} (peak {k_peak:.2f} GiB) plain "
            f"{p_terms['total_loss']:.6f} (peak {p_peak:.2f} GiB); {len(p_terms) - 1} loss "
            f"terms, worst rel diff {rel:.3e}")
        norm_rel = worst_rel(k_norms, p_norms)
        log("  grad norm per group (kernels / plain): " + ", ".join(
            f"{g} {k_norms[g]:.5g}/{p_norms[g]:.5g}" for g in sorted(p_norms))
            + f"; worst rel diff {norm_rel:.3e}")
        if rel > LOSS_RTOL:
            raise SystemExit(f"AFF-Small loss terms: kernels and plain versions differ by {rel}")
        if norm_rel > GROUP_NORM_RTOL:
            raise SystemExit("AFF-Small gradient norms per group: kernels and plain versions "
                             f"differ by {norm_rel} (rel)")
    return launches, k11


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from autofocusformermod_torch.config import aff_mini_cfg
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.losses.lapjv import lapjv
    from autofocusformermod_torch.models.inference import SemanticPredictor
    from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config
    from autofocusformermod_torch.ops.build import build_library, load_kernels
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import (sfc_cluster_attention,
                                                         sfc_cluster_attention_backward)
    from autofocusformermod_torch.ops.msdetrpc import msdetrpc_levels_s, msdetrpc_levels_s_backward
    from autofocusformermod_torch.ops.point_sample import (
        point_sample_backward, point_sample_bilinear, point_sample_nearest,
        point_sample_nearest_rows)

    dev = torch.device("cuda", 0)
    log("phase 1: build")
    t0 = time.time()
    lib_path = build_library()
    load_kernels()
    log(f"  built {lib_path.name} in {time.time() - t0:.1f} s")

    log("phase 2: kernels against their plain versions, 512x512 batch-4 shapes")
    gen = torch.Generator().manual_seed(SEED)
    local_attn_paths = {"aff_mini_b4_forward": check_local_attn(dev, gen, "aff_mini", BATCH)}
    msdetrpc_paths = {"b4_forward": check_msdetrpc(dev, gen, BATCH)}
    knn_paths = {"b4_forward": check_knn(dev, gen, BATCH)}

    log("phase 3: AFF-Mini forward, 512x512, batch 4, seeded random weights")
    cfg = aff_mini_cfg()
    model = maskformer_from_config(cfg)
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    counters = {"local_attn": sfc_cluster_attention, "msdetrpc": msdetrpc_levels_s, "knn": knn}
    expected = {"local_attn": sum(cfg.MODEL.AFF.DEPTHS),                     # 12 blocks
                "msdetrpc": cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS * 3,  # 18
                "knn": 10}  # 4 stages + 2 merges + 3 decoder tables + 1 FPN upsample
    with torch.no_grad():
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = model(images)
        torch.cuda.synchronize()
        t_fwd = time.time() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        with plain_versions():
            ref = model(images)
            fp = model.backbone(model.normalize(images))
        fk = model.backbone(model.normalize(images))
    log(f"  first forward {t_fwd:.3f} s; launches {launches} (expected {expected})")
    for name, n in launches.items():
        if n != expected[name]:
            raise SystemExit(f"{name}: launched {n} times in the forward, expected {expected[name]}")
    inference_launches = launches
    agree = kept_agreement(fk, fp)
    log(f"  kept-token agreement kernels vs plain: {agree}")
    for key, shape in (("pred_logits", (BATCH, 100, 151)), ("pred_masks", (BATCH, 100, 128, 128))):
        a, r = out[key], ref[key]
        if tuple(a.shape) != shape or not torch.isfinite(a).all():
            raise SystemExit(f"{key}: shape {tuple(a.shape)} (expected {shape}) or non-finite")
        e = (a - r).abs().max().item()
        scale = r.abs().max().item()
        log(f"  {key}: max_abs_err vs plain {e:.3e} (max |ref| {scale:.3e}, rel {e / scale:.3e})")
        if min(agree.values()) == 1.0 and e > 1e-3 * max(scale, 1.0):
            raise SystemExit(f"{key}: kernels and plain versions disagree by {e}")

    log("phase 4: predictor, 8 random uint8 512x512 images")
    predictor = SemanticPredictor(model, cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY)
    reqs = torch.randint(0, 256, (8, SIZE, SIZE, 3), generator=gen, dtype=torch.uint8)
    for bs in (1, 4):
        predictor(reqs[:bs])                     # warm-up, not timed
        torch.cuda.synchronize()
        t0 = time.time()
        labels = [predictor(reqs[i:i + bs]) for i in range(0, len(reqs), bs)]
        torch.cuda.synchronize()
        dt = time.time() - t0
        for lab in labels:
            if tuple(lab.shape[1:]) != (SIZE, SIZE) or lab.min() < 0 or lab.max() >= 150:
                raise SystemExit(f"bad label map {tuple(lab.shape)} [{lab.min()}, {lab.max()}]")
        log(f"  batch {bs}: {len(reqs)} images in {dt:.3f} s = {len(reqs) / dt:.2f} images/s "
            f"({smi}); label maps {tuple(labels[0].shape)}")

    del model, predictor, out, ref, fk, fp, images
    torch.cuda.empty_cache()

    log(f"phase 5: the kernels against their plain versions at the shapes of a 512x512 batch-"
        f"{TRAIN_BATCH} AFF-Mini step and a batch-{SMALL_BATCH} AFF-Small step")
    # the pixel decoder, the knn tables, the criterion and the matcher have
    # the same shapes in both models at one batch; the backbone's do not
    steps = {f"aff_mini_b{TRAIN_BATCH}_step": ("aff_mini", TRAIN_BATCH),
             f"aff_small_b{SMALL_BATCH}_step": ("aff_small", SMALL_BATCH)}
    local_attn_bwd_paths = {}
    for path, (name, b) in steps.items():
        local_attn_paths[path] = check_local_attn(dev, gen, name, b)
        local_attn_bwd_paths[path] = check_local_attn_bwd(dev, gen, name, b)
    for b in sorted({TRAIN_BATCH, SMALL_BATCH}):
        msdetrpc_paths[f"b{b}_step"] = check_msdetrpc(dev, gen, b)
        knn_paths[f"b{b}_step"] = check_knn(dev, gen, b)
    kernels = [local_attn_record(local_attn_paths), msdetrpc_record(msdetrpc_paths),
               knn_record(knn_paths), local_attn_bwd_record(local_attn_bwd_paths),
               check_msdetrpc_bwd(dev, gen), check_point_sample(dev, gen), check_lapjv(dev, gen)]
    torch.cuda.empty_cache()

    log(f"phase 6: AFF-Mini training step, 512x512, batch {TRAIN_BATCH}, fp32, the default "
        "criterion, seeded random weights and label maps")
    train_counters = {"local_attn": sfc_cluster_attention,
                      "local_attn_bwd": sfc_cluster_attention_backward,
                      "msdetrpc": msdetrpc_levels_s, "msdetrpc_bwd": msdetrpc_levels_s_backward,
                      "point_sample": point_sample_bilinear,
                      "point_sample_bwd": point_sample_backward, "lapjv": lapjv, "knn": knn,
                      "point_sample_nearest": point_sample_nearest,
                      "point_sample_nearest_rows": point_sample_nearest_rows}
    # per step: the default criterion reads the ranking through
    # point_sample_nearest_rows, so point_sample is left the target labels
    # and the matched logits
    per_step = {"local_attn": 12, "local_attn_bwd": 12, "msdetrpc": 18, "msdetrpc_bwd": 18,
                "point_sample": 2, "point_sample_bwd": 1, "lapjv": 1, "knn": 10,
                "point_sample_nearest": 0, "point_sample_nearest_rows": 1}
    mini_launches = train_phase(dev, smi, train_counters)
    for name, n in per_step.items():
        if mini_launches[name] != n * TRAIN_STEPS:
            raise SystemExit(f"{name}: launched {mini_launches[name]} times in {TRAIN_STEPS} "
                             f"training steps, expected {n} per step")
    torch.cuda.empty_cache()

    log(f"phase 7: the ranking's nearest-read kernels against their plain versions, batch-"
        f"{TRAIN_BATCH} step shapes")
    kernels += check_nearest(dev, gen)
    torch.cuda.empty_cache()
    check_sampler(dev, gen)
    torch.cuda.empty_cache()

    log(f"phase 8: AFF-Small training run through the command line, 512x512, batch "
        f"{SMALL_BATCH}, fp32, DropPath and layer scale, checkpoint and resume")
    small_launches, k11_launches = small_phase(dev, smi, train_counters)
    blocks = 3 + 4 + 18 + 2
    per_step.update({"local_attn": blocks, "local_attn_bwd": blocks})
    for name, n in per_step.items():
        if small_launches[name] != n * SMALL_STEPS:
            raise SystemExit(f"{name}: launched {small_launches[name]} times in {SMALL_STEPS} "
                             f"AFF-Small steps, expected {n} per step")
    if k11_launches != {"point_sample_nearest": 1, "point_sample_nearest_rows": 0}:
        raise SystemExit(f"the step with stratification off launched {k11_launches}, expected "
                         "point_sample_nearest once and point_sample_nearest_rows not at all")

    for kr in kernels:
        names = [kr["name"]] + (["point_sample_bwd"] if kr["name"] == "point_sample" else [])
        kr["inference_launches"] = inference_launches.get(kr["name"], 0)
        kr["mini_step_launches"] = sum(mini_launches[n] for n in names)
        kr["small_run_launches"] = sum(small_launches[n] + k11_launches.get(n, 0) for n in names)
        kr["launches"] = (kr["inference_launches"] + kr["mini_step_launches"]
                          + kr["small_run_launches"])
        if kr["launches"] < 1:
            raise SystemExit(f"{kr['name']}: never launched on a main path")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
