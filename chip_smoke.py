#!/usr/bin/env python3
"""Drive the PyTorch port's semantic-segmentation paths -- AFF-Mini inference,
the AFF-Mini training step, an AFF-Small training run with checkpoint and
resume, and the pixel decoder's alternate operand layouts -- on one NVIDIA GPU.

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
   stage shapes (the forward also on the card alone; the backward's two
   kernels timed apart, its reverse lists' build timed too, two calls
   compared bit for bit; both once more on random neighbour lists), and what
   is the same for both models at one batch (msdetrpc forward and backward,
   the backward on a uniform draw and on the operands of a real batch-8
   forward, two calls bit for bit; knn, point_sample forward and backward,
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
   parameter group);
9. the pixel decoder's alternate operand layouts: holds their five kernels
   (per-level, pair-major and head-natural msdetrpc, forward and backward;
   the channel-major table lookup, exact, at uniformly random indices and at
   the path's own Morton ranks, and at a table too large for its
   shared-memory route; the interleaved msdetrpc at a level
   split that is not all multiples of 128, forward and backward) against
   their plain versions at the shapes of a batch-4 forward and a batch-8
   step; runs the phase-3 forward (same weights and images) once per layout
   and compares launch counts and outputs with the default layout's, with
   ms per forward and device busy ms of each; the same at 384x384, where the
   decoder's levels are not all multiples of 128, through the interleaved
   kernel; and one batch-8 training step per layout (and a batch-2 step at
   384x384 for the interleaved one) against the default layout's step from
   the same weights, batch and generators.

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
# the image size whose decoder levels (144, 576, 2304 tokens) are not all
# multiples of 128, and the batch of its training step
ODD_SIZE, ODD_TRAIN_BATCH = 384, 2
# the pixel decoder's layouts: name -> the flags of models/pixel_decoder.py
LAYOUTS = {"per_level": {"USE_STACKED_GLUE": False}, "fused_prep": {"USE_FUSED_PREP": True},
           "head_natural": {"USE_BH_LAYOUT": True}}
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
# gradient tensor: the point_sample backward and the alternate layouts'
# msdetrpc backwards scatter with atomics (run-to-run order; the local_attn
# pair and the stacked msdetrpc backward sum in a fixed order) and the w5/b5
# reductions sum ~1e6 terms in another order
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
# optimizer, schedule, generators) is equal bit for bit, but the point_sample
# backward kernel and PyTorch's index_add scatter with atomics, whose order
# changes from run to run (the local_attn and msdetrpc backwards do not: they
# sum in a fixed order), so the two runs' weights differ in the
# last bits after the first update and the later steps' loss terms agree only to this
# (relative; two runs of the same steps mostly differ by 1e-5 to 3e-5).  At
# random initialisation a near-tied match that flips amplifies the
# difference from one step to the next (seen: 7.8e-5 at step 3, before any
# resume, then 6.4e-4 at step 4), so a step is held to the larger of
# RESUME_RTOL and RESUME_GROWTH times the worst difference of the steps
# before it.  A resume that lost state shows at once: the restored state is
# compared bit for bit, and another generator state samples other points,
# which moves the mask and dice terms by percents.
RESUME_RTOL, RESUME_GROWTH = 5e-4, 20.0


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


def queued_ms(fn, iters: int = 20) -> float:
    """Device time of fn() in ms per call, with the card kept busy: the calls
    are enqueued behind one long matrix product, so the host's launch work
    overlaps it and the two events bracket back-to-back execution.  For a
    call shorter than its own launch, whose cuda_ms is mostly the host's."""
    import torch

    fn()
    filler = torch.empty((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.matmul(filler, filler)          # ~20 ms of fp32: time to enqueue what follows
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run_ms(fn, iters: int = 50) -> float:
    """ms per call over one run of back-to-back calls between two events: the
    larger of what the host needs to launch a call and what the card needs to
    run it (cuda_ms times each call alone, from an idle card, and so adds the
    two)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    the calls of one forward (one per block), device_ms the same calls' time
    on the card alone (queued_ms)."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import sfc_cluster_attention

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    heads, dims, depths = BACKBONES[model]
    err, ms, device_ms, plain_ms, bnd = 0.0, 0.0, 0.0, 0.0, {}
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
        d_k = queued_ms(lambda: sfc_cluster_attention(*args))
        e = max((out - rout).abs().max().item(), (blank - rblank).abs().max().item())
        err = max(err, e)
        ms, plain_ms = ms + depths[s] * t_k, plain_ms + depths[s] * t_p
        device_ms += depths[s] * d_k
        # per (query, head, neighbour): q.k and p.v (4 c_) and the 5-feature
        # rel-pos bias (10); lse is the third output
        bnd = add_bounds(bnd, bound(nbytes(q, k, v, pos, nc, w5, b5, bk, out, blank, blank),
                                    b * h * n * 48 * (4 * c_ + 10)), depths[s])
        log(f"  local_attn {model} b{b} stage {s + 1} q={tuple(q.shape)} nnc*span=48: max_abs_err "
            f"{e:.3e} (rel {e / rout.abs().max().item():.3e}) kernel {t_k:.4f} ms (on the card "
            f"{d_k:.4f}), plain {t_p:.4f} ms")
        del q, k, v, out, blank, rout, rblank, args
        torch.cuda.empty_cache()
    if not err <= LOCAL_ATTN_ATOL:
        raise SystemExit(f"local_attn {model} b{b}: max abs err {err} > {LOCAL_ATTN_ATOL}")
    log(f"  local_attn {model} b{b}: per forward {ms:.3f} ms in calls, {device_ms:.3f} on the card")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "device_ms": device_ms}


def random_neighbour_case(gen, dev, b, h, n, c_, nnc):
    """Operands of local_attn on a neighbour list with no locality: random
    cluster ids with duplicates and ids past the last cluster, at an n that
    cuts the last cluster (so the plain version masks)."""
    import torch

    n_cl = -(-n // 8)
    nc = torch.randint(0, n_cl + 2, (b, n, nnc), generator=gen).int()
    nc[:, ::3, 1] = nc[:, ::3, 0]
    pos = torch.randint(0, 128, (b, n, 2), generator=gen).float()
    diff = [(torch.randn(shape, generator=gen) * scale).to(dev)
            for shape, scale in (((b, h, n, c_), c_ ** -0.5), ((b, h, n, c_), 1.0),
                                 ((b, h, n, c_), 1.0), ((h, 5), 0.1), ((h,), 0.1),
                                 ((h, c_), c_ ** -0.5))]
    return nc.to(dev), pos.to(dev), diff


RANDOM_NC_CASES = ((2, 3, 1021, 32, 6), (2, 2, 203, 5, 6))   # (b, h, n, c_, nnc)


def check_local_attn_random(dev, gen):
    """K1 on random neighbour lists (random_neighbour_case) at 32- and
    5-channel heads (16-byte and 4-byte reads): out and blank_prob against
    the plain version at LOCAL_ATTN_ATOL."""
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import sfc_cluster_attention

    worst = 0.0
    for b, h, n, c_, nnc in RANDOM_NC_CASES:
        nc, pos, (q, k, v, w5, b5, bk) = random_neighbour_case(gen, dev, b, h, n, c_, nnc)
        got = sfc_cluster_attention(q, k, v, pos, nc, w5, b5, bk, 8)
        with plain_versions():
            want = sfc_cluster_attention(q, k, v, pos, nc, w5, b5, bk, 8)
        e = max((a - r).abs().max().item() for a, r in zip(got, want))
        worst = max(worst, e)
        log(f"  local_attn random nc n={n} c_={c_}: max_abs_err {e:.3e}")
    if not worst <= LOCAL_ATTN_ATOL:
        raise SystemExit(f"local_attn on a random nc: max abs err {worst} > {LOCAL_ATTN_ATOL}")
    return {"max_abs_err": worst, "cases": [list(c) for c in RANDOM_NC_CASES]}


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
    gradients of the kernel pair against the plain version's autograd, and
    two calls on the same inputs bit for bit; ms sums the backward calls of a
    step, one per block (the kernel pair alone, the reverse lists given, vs
    the plain version's autograd backward alone).  dq_ms and dkv_ms are the
    device times of the query-side and key-side kernels (queued_ms), summed
    the same way; reverse_ms is the build of the stage's reverse lists, once
    per stage."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import (
        backward_key_side, backward_query_side, build_reverse_lists, local_attn_forward,
        sfc_cluster_attention, sfc_cluster_attention_backward)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    heads, dims, depths = BACKBONES[model]
    err, worst, ms, plain_ms, bnd = 0.0, 0.0, 0.0, 0.0, {}
    dq_ms, dkv_ms, reverse_ms, fan_in = 0.0, 0.0, 0.0, 0
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
        rev = build_reverse_lists(nc, n, 8)
        fan_in = max(fan_in, (rev.offsets[:, 1:] - rev.offsets[:, :-1]).max().item())

        def bwd():
            return sfc_cluster_attention_backward(q, k, v, pos, nc, w5, b5, g, lse, delta, 8, rev)

        # no atomics: the same inputs give the same bits, also with lists
        # the wrapper builds itself
        first = bwd()
        again = sfc_cluster_attention_backward(q, k, v, pos, nc, w5, b5, g, lse, delta, 8)
        if not all(torch.equal(a, r) for a, r in zip(first, again)):
            raise SystemExit(f"local_attn backward {model} b{b} stage {s + 1}: two calls on the "
                             "same inputs differ")
        t_k = cuda_ms(bwd)
        t_r = cuda_ms(lambda: build_reverse_lists(nc, n, 8))
        _, _, p_, ds_ = backward_query_side(q, k, v, pos, nc, w5, b5, g, lse, delta, 8)
        t_dq = queued_ms(lambda: backward_query_side(q, k, v, pos, nc, w5, b5, g, lse, delta, 8))
        t_dkv = queued_ms(lambda: backward_key_side(q, g, p_, ds_, rev, 6, 8))
        del p_, ds_
        t_p = plain_grad_ms(fwd, leaves, (g, gb))
        ms, plain_ms = ms + depths[s] * t_k, plain_ms + depths[s] * t_p
        dq_ms, dkv_ms, reverse_ms = dq_ms + depths[s] * t_dq, dkv_ms + depths[s] * t_dkv, reverse_ms + t_r
        # per (query, head, neighbour): q.k again, g.v, and the three
        # products into dq, dk, dv (10 c_), and the bias and its gradient (20);
        # out: dq, dk, dv and the per-query rel-pos partials (5 per head)
        bnd = add_bounds(bnd, bound(nbytes(q, k, v, pos, nc, w5, b5, g, lse, delta, q, k, v)
                                    + 4 * b * h * n * 5,
                                    b * h * n * 48 * (10 * c_ + 20)), depths[s])
        log(f"  local_attn bwd {model} b{b} stage {s + 1} q={tuple(q.shape)}: max_abs_err {e:.3e} "
            f"(rel {rel:.3e}; dq dk dv dw5 db5 dblank_k), bit-identical twice; kernel pair "
            f"{t_k:.4f} ms a call (device: query side {t_dq:.4f}, key side {t_dkv:.4f}), "
            f"reverse lists {t_r:.4f} ms, plain {t_p:.4f} ms")
        del diff, leaves, got, want, first, again, q, k, v, g, gb, out, blank, lse, delta, rev
        torch.cuda.empty_cache()
    if not worst <= GRAD_RTOL:
        raise SystemExit(f"local_attn backward {model} b{b}: max rel err {worst} > {GRAD_RTOL}")
    log(f"  local_attn bwd {model} b{b}: per step {ms:.3f} ms in calls, device {dq_ms:.3f} query "
        f"side + {dkv_ms:.3f} key side, reverse lists {reverse_ms:.3f} ms (4 builds); largest "
        f"fan-in {fan_in} references to one key cluster (mean 48)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "dq_ms": dq_ms,
            "dkv_ms": dkv_ms, "reverse_ms": reverse_ms, "max_fan_in": fan_in}


def check_local_attn_bwd_random(dev, gen):
    """K2 on a neighbour list with no locality, at a small shape: random
    cluster ids with duplicates and ids past the last cluster, n not a
    multiple of the cluster size (so the last cluster is cut and the plain
    version masks), once with 32-channel heads and once with 5-channel ones
    (4-byte reads).  Against the plain version's autograd, and twice."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import sfc_cluster_attention

    worst = 0.0
    for b, h, n, c_, nnc in RANDOM_NC_CASES:
        nc, pos, diff = random_neighbour_case(gen, dev, b, h, n, c_, nnc)
        leaves = [t.requires_grad_() for t in diff]
        g, gb = torch.randn((b, h, n, c_), generator=gen).to(dev), torch.randn(
            (b, h, n, 1), generator=gen).to(dev)

        def grads():
            q, k, v, w5, b5, bk = leaves
            return torch.autograd.grad(sfc_cluster_attention(q, k, v, pos, nc, w5, b5, bk, 8),
                                       leaves, (g, gb))

        got, again = grads(), grads()
        with plain_versions():
            want = grads()
        e, rel = grad_errs(got, want)
        same = all(torch.equal(a, r) for a, r in zip(got, again))
        worst = max(worst, rel)
        log(f"  local_attn bwd random nc n={n} c_={c_}: max_abs_err {e:.3e} (rel {rel:.3e}), "
            f"bit-identical twice: {same}")
        if not same:
            raise SystemExit("local_attn backward on a random nc: two calls differ")
    if not worst <= GRAD_RTOL:
        raise SystemExit(f"local_attn backward on a random nc: max rel err {worst} > {GRAD_RTOL}")
    return worst


def local_attn_bwd_record(paths: dict) -> dict:
    return {"name": "local_attn_bwd", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/local_attn.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/local_attn.py:622",
            "library_ms": None, "deterministic": True,
            **per_path(paths, f"aff_mini_b{TRAIN_BATCH}_step")}


def path_msdetrpc_operands(dev, b=TRAIN_BATCH):
    """The operands (idx_s, w_s, val, level sizes) of every msdetrpc call of
    one batch-b AFF-Mini forward at 512x512 (seeded weights and images), as
    the main path makes them: 18 calls.  A query samples the 4 nearest cells
    around its own position plus small offsets, and queries come in the
    backbone's curve order, so neighbouring queries read neighbouring rows."""
    import torch
    from autofocusformermod_torch.config import aff_mini_cfg
    from autofocusformermod_torch.models import pixel_decoder
    from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config

    model = maskformer_from_config(aff_mini_cfg())
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    images = torch.randint(0, 256, (b, SIZE, SIZE, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(SEED + 2)).to(dev)
    calls, real = [], pixel_decoder.msdetrpc_levels_s

    def capture(idx_s, w_s, val, level_sizes):
        calls.append((idx_s.clone(), w_s.clone(), val.clone(), tuple(level_sizes)))
        return real(idx_s, w_s, val, level_sizes)

    pixel_decoder.msdetrpc_levels_s = capture
    try:
        with torch.no_grad():
            model(images)
    finally:
        pixel_decoder.msdetrpc_levels_s = real
    return calls


def check_msdetrpc_bwd(dev, gen):
    """K4 at a batch-8 step's shapes (bh=64, 3 levels x 16 pairs, c_=32) on
    two index sets: the uniform draw of earlier records, and the path's own
    operands (path_msdetrpc_operands: the 18 calls of a batch-8 AFF-Mini
    forward), whose figures are the record's own.  Each against the plain
    version's autograd, and twice, bit for bit (the kernels sum in a fixed
    order).  ms sums the 18 backward calls of a step; device_ms the same on
    the card alone (queued_ms)."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.msdetrpc import (
        msdetrpc_levels_s, msdetrpc_levels_s_backward)

    bh, p, c_, sizes = TRAIN_BATCH * 8, 16, 32, (256, 1024, 4096)
    val = torch.randn((bh, sum(sizes), c_), generator=gen).to(dev)
    uniform = []
    for n in sizes:
        idx = torch.cat([torch.randint(0, s, (bh, n, p), generator=gen) for s in sizes], 2)
        w = torch.rand((bh, n, 3 * p), generator=gen)
        uniform.append((idx.int().to(dev).contiguous(),
                        (w / w.sum(-1, keepdim=True)).to(dev).contiguous(), val, sizes, 6))
    sets = {"uniform": uniform,
            "path": [(*call, 1) for call in path_msdetrpc_operands(dev)]}
    paths = {}
    for label in list(sets):
        calls = sets.pop(label)          # each set's operands are freed after its turn
        err, worst, ms, device_ms, plain_ms, bnd = 0.0, 0.0, 0.0, 0.0, 0.0, {}
        for idx, w, v, lv_sizes, times in calls:
            n = idx.shape[1]
            g = torch.randn((bh, n, c_), generator=gen).to(dev)
            leaves = [w.clone().requires_grad_(), v.clone().requires_grad_()]

            def fwd():
                return msdetrpc_levels_s(idx, leaves[0], leaves[1], lv_sizes)

            got = torch.autograd.grad(fwd(), leaves, g)
            with plain_versions():
                want = torch.autograd.grad(fwd(), leaves, g)
            e, rel = grad_errs(got, want)
            err, worst = max(err, e), max(worst, rel)
            first = msdetrpc_levels_s_backward(idx, w, v, g, lv_sizes)
            again = msdetrpc_levels_s_backward(idx, w, v, g, lv_sizes)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise SystemExit(f"msdetrpc backward ({label}, n={n}): two calls on the same "
                                 "inputs differ")
            t_k = cuda_ms(lambda: msdetrpc_levels_s_backward(idx, w, v, g, lv_sizes))
            d_k = queued_ms(lambda: msdetrpc_levels_s_backward(idx, w, v, g, lv_sizes))
            t_p = plain_grad_ms(fwd, leaves, g)
            ms, device_ms, plain_ms = ms + times * t_k, device_ms + times * d_k, plain_ms + times * t_p
            # d_val += w * g and d_w = g . val: 4 operations per (query, pair, channel)
            bnd = add_bounds(bnd, bound(nbytes(idx, w, v, g, w, v), 4 * bh * n * 3 * p * c_), times)
            log(f"  msdetrpc bwd {label} n={n} idx={tuple(idx.shape)} val={tuple(v.shape)}: "
                f"max_abs_err {e:.3e} (rel {rel:.3e}; d_w d_val), bit-identical twice; kernel "
                f"{t_k:.4f} ms (on the card {d_k:.4f}), plain {t_p:.4f} ms")
            del g, leaves, got, want, first, again
        if not worst <= GRAD_RTOL:
            raise SystemExit(f"msdetrpc backward ({label}): max rel err {worst} > {GRAD_RTOL}")
        log(f"  msdetrpc bwd {label}: per step {ms:.3f} ms in calls, {device_ms:.3f} on the card, "
            f"bound {bnd['bound_ms']:.3f} ms")
        paths[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                        "device_ms": device_ms}
        del calls
        torch.cuda.empty_cache()
    return {"name": "msdetrpc_bwd", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/msdetrpc.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:2078",
            "library_ms": None, "deterministic": True, **per_path(paths, "path")}


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
    check_lapjv_bad_costs(dev, gen)
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


def layout_operands(gen, dev, bh, n, sizes, p=16, heads=8):
    """One query level's sampling operands in every layout, from the same
    random indices and weights: per level (bh, n, P); pair-major (bh, P, n);
    head-natural (b, n, h, P); interleaved (bh, n, m, 4) global indices with
    slot = point * L + level and the attention apart (here 1)."""
    import torch

    idxs = [torch.randint(0, s, (bh, n, p), generator=gen).int().to(dev) for s in sizes]
    w = torch.rand((bh, n, len(sizes) * p), generator=gen)
    ws = [x.contiguous().to(dev) for x in (w / w.sum(-1, keepdim=True)).split(p, dim=2)]
    b = bh // heads

    def bh_form(x):
        return x.reshape(b, heads, *x.shape[1:]).transpose(1, 2).contiguous()

    offs = [sum(sizes[:j]) for j in range(len(sizes))]
    k = p // 4
    nn_idx = torch.stack([(i + o).reshape(bh, n, k, 4) for i, o in zip(idxs, offs)], 3)
    nn_w = torch.stack([x.reshape(bh, n, k, 4) for x in ws], 3)
    return {"levels": (idxs, ws), "levels_t": ([i.transpose(1, 2).contiguous() for i in idxs],
                                               [x.transpose(1, 2).contiguous() for x in ws]),
            "bh": ([bh_form(i) for i in idxs], [bh_form(x) for x in ws]),
            "interleaved": (nn_idx.reshape(bh, n, -1, 4).contiguous(),
                            nn_w.reshape(bh, n, -1, 4).contiguous(),
                            torch.rand((bh, n, k * len(sizes)), generator=gen).to(dev) + 0.5)}


# the four sampling kernels of the alternate layouts: record name (for the
# first three also the wrapper's name in ops/msdetrpc.py) -> (key of its
# operands in layout_operands, line of the TPU function in msdetrpc_kernel.py)
SAMPLING = {"msdetrpc_levels": ("levels", 1841), "msdetrpc_levels_t": ("levels_t", 1912),
            "msdetrpc_bh": ("bh", 2359), "msdetrpc_interleaved": ("interleaved", 1204)}


def check_sampling_layouts(dev, gen, b, backward):
    """K5, K7, K8 at a batch-b 512x512 pass's shapes and K6 at a 384x384
    one's (bh = 8 b, 3 levels x 16 pairs, c_ = 32), each against its plain
    version on its own operands; with `backward`, the gradients and the
    backward kernels' times instead of the forward's.  ms sums the calls of
    one pass: 6 encoder layers x the query levels that reach the kernel (all
    three; the 4096-token level alone for the pair-major one)."""
    import torch
    from autofocusformermod_torch.ops import clusten, msdetrpc as md
    from autofocusformermod_torch.ops.dispatch import plain_versions

    bh, p, c_, heads = b * 8, 16, 32, 8
    results = {}
    for name, (key, _) in SAMPLING.items():
        sizes = (144, 576, 2304) if key == "interleaved" else (256, 1024, 4096)
        val = torch.randn((bh, sum(sizes), c_), generator=gen).to(dev)
        if key == "bh":
            val = val.reshape(b, heads, -1, c_).transpose(1, 2).contiguous()
        err, worst, ms, plain_ms, bnd = 0.0, 0.0, 0.0, 0.0, {}
        for n in (sizes[-1:] if key == "levels_t" else sizes):
            ops = layout_operands(gen, dev, bh, n, sizes)[key]
            g = torch.randn((bh, n, c_), generator=gen).to(dev)
            if key == "bh":
                g = g.reshape(b, heads, n, c_).transpose(1, 2).contiguous()
            if key == "interleaved":
                idx, w, attn = ops
                diff = [w, attn, val]
                launch_bwd = lambda: clusten.msdetrpc_backward(idx, w, attn, val, g)

                def fwd(leaves=diff):
                    return clusten.msdetrpc(idx, *leaves)
            else:
                fn = getattr(md, name)
                idxs, ws = ops
                diff = [val, *ws]
                launch_bwd = lambda: fn.backward_launcher(idxs, ws, val, g, sizes)

                def fwd(leaves=diff):
                    return fn(idxs, leaves[1:], leaves[0], sizes)
            moved = nbytes(*(ops[0] if key != "interleaved" else ops[:1]), *diff)
            if not backward:
                out = fwd()
                with plain_versions():
                    ref = fwd()
                    t_p = cuda_ms(fwd, iters=5, warmup=1)
                t_k = cuda_ms(fwd)
                e = (out - ref).abs().max().item()
                err, rel = max(err, e), e / ref.abs().max().item()
                # a multiply and an add per (query, pair, channel)
                bnd = add_bounds(bnd, bound(moved + nbytes(out), 2 * bh * n * 3 * p * c_), 6)
            else:
                leaves = [t.clone().requires_grad_() for t in diff]
                got = torch.autograd.grad(fwd(leaves), leaves, g)
                with plain_versions():
                    want = torch.autograd.grad(fwd(leaves), leaves, g)
                e, rel = grad_errs(got, want)
                err, worst = max(err, e), max(worst, rel)
                t_k = cuda_ms(launch_bwd)
                t_p = plain_grad_ms(lambda: fwd(leaves), leaves, g)
                # d_val += w g and d_w = g . val: 4 operations per (query, pair, channel)
                bnd = add_bounds(bnd, bound(moved + nbytes(g, *diff), 4 * bh * n * 3 * p * c_), 6)
            ms, plain_ms = ms + 6 * t_k, plain_ms + 6 * t_p
            log(f"  {name} {'bwd' if backward else 'fwd'} b{b} n={n} levels={sizes}: max_abs_err "
                f"{e:.3e} (rel {rel:.3e}) kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
            del ops, g
        if (worst > GRAD_RTOL) if backward else (err > MSDETRPC_ATOL):
            raise SystemExit(f"{name} {'backward' if backward else 'forward'} b{b}: kernel and "
                             f"plain version disagree (abs {err}, rel {worst})")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd}
        del val
        torch.cuda.empty_cache()
    return results


def path_sample_ranks(dev, gen, b, heads=8, points=4):
    """Morton ranks as the channel-major prep makes them for the 4096-token
    level (models/pixel_decoder.py:_level_fused_t): 4096 query positions on the
    128x128 canvas in the backbone's curve order, plus (heads, points) offsets
    of a few cells each, rounded half to even, clamped and ranked; (b, heads *
    points * 4096) int32 with the queries minor, so neighbouring samples fall
    in neighbouring cells."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.morton import morton_rank

    pos = space_filling_cluster(grid_pos(64, 2, 1, dev), 8, 128, 128)[0]     # (1, 4096, 2)
    offs = (torch.randn((b, heads, points, 2, pos.shape[1]), generator=gen) * 2.0).to(dev)
    sl = torch.round(pos.transpose(1, 2)[:, None, None] + offs).int()         # (b, h, k, 2, n)
    gx = torch.clamp(sl[:, :, :, 0], 0, 127)
    gy = torch.clamp(sl[:, :, :, 1], 0, 127)
    return morton_rank(gx, gy, 7, 7).reshape(b, -1).contiguous()


def check_window_gather(dev, gen, b):
    """K14 at a batch-b forward's one shape (the 4096-token level: 12-channel
    table over 128x128 cells, 8 heads x 4 points x 4096 queries = 131072
    samples), at two index distributions: uniformly random rows (the worst
    case for locality) and the path's own (path_sample_ranks).  Exact equality
    with the plain version; ms sums a forward's 18 calls (6 layers x 3 value
    levels).  The library call is one torch.gather on an index expanded over
    the channels beforehand.  Three times each: per call alone (`ms`, from
    cuda_ms as every record; for a kernel this short mostly the host's launch
    work), per call in a run of calls (`run_ms`: the larger of the host's and
    the card's share) and on the card alone (`device_ms`, from queued_ms);
    `direct_kernel_device_ms` is the direct route's kernel on the same
    operands.  The record's own figures
    are the uniform case's, as every earlier record's; by_path has both.
    Then once at a table too large for shared memory (256x256 cells), where
    the direct route runs."""
    import torch
    from autofocusformermod_torch.ops.build import load_kernels
    from autofocusformermod_torch.ops.dispatch import plain_versions, stream_of
    from autofocusformermod_torch.ops.window_gather import (
        window_gather_route, windowed_row_gather)

    lib = load_kernels()

    def hold(label, table, idx, route):
        bb, c, n = table.shape
        s = idx.shape[1]
        if window_gather_route(n, s) != route:
            raise SystemExit(f"window_gather {label}: expected the {route} route")
        before = dict(windowed_row_gather.launches_by_route)
        out = windowed_row_gather(table, idx)
        took = {r: windowed_row_gather.launches_by_route[r] - before[r] for r in before}
        if took != {r: int(r == route) for r in before}:
            raise SystemExit(f"window_gather {label}: route counts moved by {took}")
        with plain_versions():
            ref = windowed_row_gather(table, idx)
            t_p = cuda_ms(lambda: windowed_row_gather(table, idx))
        t_k = cuda_ms(lambda: windowed_row_gather(table, idx))
        wide = idx.long()[:, None, :].expand(bb, c, s).contiguous()
        t_l = cuda_ms(lambda: torch.gather(table, 2, wide))
        d_k = queued_ms(lambda: windowed_row_gather(table, idx))
        d_l = queued_ms(lambda: torch.gather(table, 2, wide))
        r_k = run_ms(lambda: windowed_row_gather(table, idx))
        r_l = run_ms(lambda: torch.gather(table, 2, wide))
        # the direct kernel on the same operands (the whole of the kernel
        # before it had a shared-memory route), launched past the wrapper
        scratch = torch.empty_like(out)
        d_d = queued_ms(lambda: lib.aff_window_gather(
            table.data_ptr(), idx.data_ptr(), scratch.data_ptr(), bb, c, n, s, stream_of(table)))
        same = (torch.equal(out, ref) and torch.equal(torch.gather(table, 2, wide), ref)
                and torch.equal(scratch, ref))
        bnd = bound(nbytes(table, idx, out), 0)
        log(f"  window_gather b{bb} {label} table={tuple(table.shape)} samples={s} route={route}: "
            f"identical={same}; per call alone: kernel {t_k:.4f} ms, plain {t_p:.4f}, torch.gather "
            f"{t_l:.4f}; in a run of calls: kernel {r_k:.4f}, torch.gather {r_l:.4f}; on the "
            f"card: kernel {d_k:.4f}, direct kernel {d_d:.4f}, torch.gather {d_l:.4f}; bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        if not same:
            raise SystemExit(f"window_gather {label}: kernel, plain version and torch.gather "
                             "disagree")
        return {"max_abs_err": 0.0, "kernel_route": route, "ms": 18 * t_k, "plain_ms": 18 * t_p,
                "library_ms": 18 * t_l, "run_ms": 18 * r_k, "library_run_ms": 18 * r_l,
                "device_ms": 18 * d_k, "direct_kernel_device_ms": 18 * d_d,
                "library_device_ms": 18 * d_l,
                "bound_ms": 18 * bnd["bound_ms"], "bound_by": bnd["bound_by"]}

    c, n, s = 12, 128 * 128, 8 * 4 * 4096
    table = torch.randn((b, c, n), generator=gen).to(dev)
    paths = {"uniform": hold("uniform indices", table,
                             torch.randint(0, n, (b, s), generator=gen).int().to(dev), "shared"),
             "path_morton": hold("the path's Morton ranks", table,
                                 path_sample_ranks(dev, gen, b), "shared")}
    n_big = 256 * 256
    big = torch.randn((b, c, n_big), generator=gen).to(dev)
    paths["direct_route_256x256"] = hold(
        "a table too large for shared memory", big,
        torch.randint(0, n_big, (b, s), generator=gen).int().to(dev), "direct")
    first = paths["uniform"]
    return {**{k: first[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "run_ms",
                                     "library_run_ms", "device_ms", "library_device_ms",
                                     "bound_ms", "bound_by")},
            "by_path": paths}


def check_lapjv_bad_costs(dev, gen, limit_s=20.0):
    """The matcher's kernel on NaN and +-inf costs: it must end (a NaN counts
    as the largest cost) and agree with the plain version.  A loop that never
    ends would hang the process, so the launch is watched from the host: the
    stream is polled against a time limit of its own."""
    import torch
    from autofocusformermod_torch.losses.lapjv import hungarian_lsap, lapjv

    cost = torch.rand((6, 100, 100), generator=gen) * 10 - 5
    cost[0] = float("nan")
    cost[1, 10:20] = float("nan")
    cost[2, :, 30:60] = float("nan")
    cost[3, 5, 5], cost[3, 6, 7] = float("inf"), float("-inf")
    cost[4] = float("inf")
    cost[5, ::2, ::3] = float("nan")
    cost[:, :, 90:] = 1e8
    cost = cost.to(dev)
    done = torch.cuda.Event()
    t0 = time.time()
    got = lapjv(cost)
    done.record()
    while not done.query():
        if time.time() - t0 > limit_s:
            log(f"  lapjv on NaN / inf costs: still running after {limit_s} s")
            sys.stdout.flush()
            import os
            os._exit(1)       # the kernel cannot be stopped; leave without waiting for it
        time.sleep(0.01)
    took = time.time() - t0
    same = torch.equal(got, hungarian_lsap(cost))
    distinct = all(len(set(row)) == 100 for row in got.tolist())
    # the same problems with the bad values written out: what the 90 real
    # targets of each cost, NaN or not (a step's problems have 8-12)
    clean = torch.nan_to_num(cost, nan=3e4).clamp(-3e4, 3e4)
    t_clean = cuda_ms(lambda: lapjv(clean), iters=1, warmup=0)
    log(f"  lapjv on NaN / inf costs {tuple(cost.shape)}, 90 real targets each: ended in "
        f"{took:.3f} s (the same costs cleaned beforehand: {t_clean:.1f} ms), identical to the "
        f"plain version={same}, distinct queries={distinct}")
    if not (same and distinct):
        raise SystemExit("lapjv on NaN / inf costs: kernel and plain version disagree")


def device_busy(fn, runs=3):
    """(device busy ms, device rows) per call of fn: the profiler's kernel and
    memcpy rows summed, ranges left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return (sum(e.self_device_time_total for e in rows) / 1e3 / runs,
            sum(e.count for e in rows) / runs)


class decoder_layout:
    """Within the block the pixel decoder builds its sampling operands in the
    named layout (None: the default)."""

    def __init__(self, name):
        self.flags = {"USE_STACKED_GLUE": True, "USE_FUSED_PREP": False, "USE_BH_LAYOUT": False,
                      **(LAYOUTS[name] if name else {})}

    def __enter__(self):
        from autofocusformermod_torch.models import pixel_decoder

        self.saved = {k: getattr(pixel_decoder, k) for k in self.flags}
        for k, v in self.flags.items():
            setattr(pixel_decoder, k, v)

    def __exit__(self, *exc):
        from autofocusformermod_torch.models import pixel_decoder

        for k, v in self.saved.items():
            setattr(pixel_decoder, k, v)


def layouts_phase(dev, smi, images, default_out, counters):
    """Phase 9's end-to-end part.  Returns {counter name: launches on the
    layouts' forwards and steps}."""
    import copy

    import torch
    from autofocusformermod_torch.config import aff_mini_cfg
    from autofocusformermod_torch.data.synthetic import synthetic_batch
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config

    cfg = aff_mini_cfg()
    model = maskformer_from_config(cfg)
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    total = dict.fromkeys(counters, 0)

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items() if c.launches}
        for name, n in got.items():
            total[name] += n
        return out, got

    def compare(label, out, ref):
        for key in ("pred_logits", "pred_masks"):
            if out[key].shape != ref[key].shape:
                raise SystemExit(f"{label} {key}: shape {tuple(out[key].shape)}")
            e = (out[key] - ref[key]).abs().max().item()
            scale = ref[key].abs().max().item()
            log(f"    {key}: max_abs_err vs the default layout {e:.3e} (max |ref| {scale:.3e})")
            if not torch.isfinite(out[key]).all() or e > 1e-3 * max(scale, 1.0):
                raise SystemExit(f"{label} {key}: differs from the default layout by {e}")

    def forward_ms(imgs):
        def run():
            with torch.no_grad():
                model(imgs)
            torch.cuda.synchronize()
        times = []
        for i in range(7):
            t0 = time.time()
            run()
            times.append((time.time() - t0) * 1e3)
        busy, rows = device_busy(run)
        return statistics.median(times[2:]), busy, rows

    # the batch-4 forward at 512x512, once per layout, against phase 3's
    sampling = ("msdetrpc", "msdetrpc_levels", "msdetrpc_levels_t", "msdetrpc_bh",
                "msdetrpc_interleaved", "window_gather")
    expected = {None: {"msdetrpc": 18}, "per_level": {"msdetrpc_levels": 18},
                "fused_prep": {"msdetrpc_levels_t": 6, "window_gather": 18, "msdetrpc": 12},
                "head_natural": {"msdetrpc_bh": 18}}
    for name in (None, *LAYOUTS):
        with decoder_layout(name), torch.no_grad():
            out, got = counted(lambda: model(images))
            got = {k: v for k, v in got.items() if k in sampling}
            ms, busy, rows = forward_ms(images)
        log(f"  layout {name or 'default'}: launches {got}; {ms:.2f} ms per batch-{BATCH} forward, "
            f"device busy {busy:.2f} ms in {rows:.0f} rows ({smi})")
        if got != expected[name]:
            raise SystemExit(f"layout {name}: launched {got}, expected {expected[name]}")
        compare(f"layout {name}", out, default_out)

    with torch.no_grad():
        ms, busy, rows = forward_ms(images)
    log(f"  layout default, timed again after the others (the spread of the host's clock within "
        f"this call): {ms:.2f} ms per forward, device busy {busy:.2f} ms in {rows:.0f} rows")

    # 384x384: levels of 144, 576 and 2304 tokens, so with USE_STACKED_GLUE
    # off the interleaved kernel takes the contraction
    odd = images[:, :ODD_SIZE, :ODD_SIZE].contiguous()
    with torch.no_grad():
        feats = model.backbone(model.normalize(odd))
        sizes = [feats[f"res{i}"].shape[1] for i in (5, 4, 3)]
        if all(n % 128 == 0 for n in sizes):
            raise SystemExit(f"{ODD_SIZE}x{ODD_SIZE}: decoder levels {sizes} are all multiples of 128")
        ref, got_ref = counted(lambda: model(odd))
        ms_ref, busy_ref, rows_ref = forward_ms(odd)
        with decoder_layout("per_level"):
            out, got = counted(lambda: model(odd))
            ms, busy, rows = forward_ms(odd)
    got = {k: v for k, v in got.items() if k in sampling}
    log(f"  {ODD_SIZE}x{ODD_SIZE}, decoder levels {sizes}: USE_STACKED_GLUE off launches {got}; "
        f"{ms:.2f} ms per forward, busy {busy:.2f} ms in {rows:.0f} rows; default layout "
        f"{ms_ref:.2f} ms, busy {busy_ref:.2f} ms in {rows_ref:.0f} rows ({smi})")
    if got != {"msdetrpc_interleaved": 18} or got_ref.get("msdetrpc") != 18:
        raise SystemExit(f"{ODD_SIZE}x{ODD_SIZE}: launched {got} (default {got_ref}), expected 18 "
                         "of the interleaved kernel and none of the per-level one")
    compare(f"{ODD_SIZE}x{ODD_SIZE} interleaved", out, ref)
    del out, ref, feats

    # one training step per layout against the default layout's, from the
    # same weights, batch and generators
    model.train()
    initial = copy.deepcopy(model.state_dict())
    bwd = {"per_level": {"msdetrpc_levels": 18, "msdetrpc_levels_bwd": 18},
           "fused_prep": {"msdetrpc_levels_t": 6, "msdetrpc_levels_t_bwd": 6, "window_gather": 18,
                          "msdetrpc": 12, "msdetrpc_bwd": 12},
           "head_natural": {"msdetrpc_bh": 18, "msdetrpc_bh_bwd": 18},
           "interleaved": {"msdetrpc_interleaved": 18, "msdetrpc_interleaved_bwd": 18}}
    sampling_bwd = sampling + tuple(n + "_bwd" for n in sampling if n != "window_gather")

    def step(batch):
        model.load_state_dict(initial)
        torch.cuda.synchronize()
        t0 = time.time()
        (total_loss, losses, _), got = counted(lambda: TrainStep(model, cfg).loss_and_grads(
            batch, device_draw(torch.Generator(device=dev).manual_seed(SEED))))
        dt = (time.time() - t0) * 1e3
        terms = {"total_loss": total_loss.item(), **{k: v.item() for k, v in losses.items()}}
        return terms, group_norms(model), {k: v for k, v in got.items() if k in sampling_bwd}, dt

    def worst_rel(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in b)

    for size, batch_size, names in ((SIZE, TRAIN_BATCH, tuple(LAYOUTS)),
                                    (ODD_SIZE, ODD_TRAIN_BATCH, ("interleaved",))):
        batch = synthetic_batch(torch.Generator().manual_seed(SEED + 1), dev, batch_size,
                                (size, size), cfg.TPU.MAX_GT_INSTANCES,
                                cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
        step(batch)                                  # warm-up, not compared
        ref_terms, ref_norms, ref_got, ref_dt = step(batch)
        log(f"  step {size}x{size} batch {batch_size}, default layout: total loss "
            f"{ref_terms['total_loss']:.6f}, {ref_dt:.1f} ms forward + criterion + backward, "
            f"launches {ref_got}")
        for name in names:
            with decoder_layout("per_level" if name == "interleaved" else name):
                terms, norms, got, dt = step(batch)
            rel, norm_rel = worst_rel(terms, ref_terms), worst_rel(norms, ref_norms)
            log(f"  step {size}x{size} batch {batch_size}, layout {name}: total loss "
                f"{terms['total_loss']:.6f}, {len(terms) - 1} loss terms worst rel diff {rel:.3e}, "
                f"grad norms per group worst rel diff {norm_rel:.3e}, {dt:.1f} ms, launches {got} "
                f"({smi})")
            if got != bwd[name]:
                raise SystemExit(f"step under layout {name}: launched {got}, expected {bwd[name]}")
            if not all(v == v and abs(v) != float("inf") for v in terms.values()):
                raise SystemExit(f"step under layout {name}: non-finite loss terms")
            if rel > LOSS_RTOL or norm_rel > GROUP_NORM_RTOL:
                raise SystemExit(f"step under layout {name}: loss terms differ by {rel}, gradient "
                                 f"norms by {norm_rel} (rel) from the default layout's")
        del batch
        torch.cuda.empty_cache()
    return total


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
        before = 0.0
        for step in range(1, SMALL_STEPS + 1):
            rel = worst_rel(loss_terms(resumed[step]), loss_terms(whole[step]))
            exact = loss_terms(resumed[step]) == loss_terms(whole[step])
            limit = max(RESUME_RTOL, RESUME_GROWTH * before)
            log(f"  step {step}{' (resumed)' if step == SMALL_STEPS else ''}: loss terms against "
                f"the uninterrupted run: worst rel diff {rel:.3e} (limit {limit:.1e}), exactly "
                f"equal: {exact}")
            if rel > limit:
                raise SystemExit(f"step {step}: the two runs' loss terms differ by {rel} (rel), "
                                 f"limit {limit}")
            before = max(before, rel)

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

    default_out = {key: out[key] for key in ("pred_logits", "pred_masks")}
    del model, predictor, out, ref, fk, fp
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
    local_attn_paths["random_nc"] = check_local_attn_random(dev, gen)
    check_local_attn_bwd_random(dev, gen)
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

    log(f"phase 9: the pixel decoder's alternate operand layouts: their kernels at the shapes of "
        f"a batch-{BATCH} forward and a batch-{TRAIN_BATCH} step, then each layout end to end")
    from autofocusformermod_torch.ops import clusten
    from autofocusformermod_torch.ops import msdetrpc as md
    from autofocusformermod_torch.ops.window_gather import windowed_row_gather

    layout_fwd = check_sampling_layouts(dev, gen, BATCH, backward=False)
    layout_bwd = check_sampling_layouts(dev, gen, TRAIN_BATCH, backward=True)
    for name, (_, line) in SAMPLING.items():
        f, b = layout_fwd[name], layout_bwd[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": "autofocusformermod_torch/csrc/msdetrpc.cu",
                        "replaces": f"autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:{line}",
                        "library_ms": None, **f, "max_abs_err": max(f["max_abs_err"],
                                                                    b["max_abs_err"]),
                        "by_path": {f"b{BATCH}_forward": f, f"b{TRAIN_BATCH}_step_backward": b}})
    kernels.append({"name": "window_gather", "route": "cuda",
                    "source": "autofocusformermod_torch/csrc/window_gather.cu",
                    "replaces": "autofocusformermod_tpu/ops/pallas/window_gather.py:92",
                    **check_window_gather(dev, gen, BATCH)})
    layout_counters = {
        "msdetrpc": msdetrpc_levels_s, "msdetrpc_bwd": msdetrpc_levels_s_backward,
        "msdetrpc_levels": md.msdetrpc_levels, "msdetrpc_levels_bwd": md.msdetrpc_levels_backward,
        "msdetrpc_levels_t": md.msdetrpc_levels_t,
        "msdetrpc_levels_t_bwd": md.msdetrpc_levels_t_backward,
        "msdetrpc_bh": md.msdetrpc_bh, "msdetrpc_bh_bwd": md.msdetrpc_bh_backward,
        "msdetrpc_interleaved": clusten.msdetrpc,
        "msdetrpc_interleaved_bwd": clusten.msdetrpc_backward,
        "window_gather": windowed_row_gather}
    by_route = dict(windowed_row_gather.launches_by_route)
    layout_launches = layouts_phase(dev, smi, images, default_out, layout_counters)
    by_route = {r: windowed_row_gather.launches_by_route[r] - n for r, n in by_route.items()}
    log(f"  window_gather launches by route on the layouts' forwards and steps: {by_route}")
    if by_route["direct"] or by_route["shared"] < 18:
        raise SystemExit(f"the channel-major prep's lookups took the routes {by_route}; the "
                         "path's shape belongs to the shared route")
    del images, default_out
    torch.cuda.empty_cache()

    for kr in kernels:
        names = [kr["name"]] + (["point_sample_bwd"] if kr["name"] == "point_sample" else [])
        kr["inference_launches"] = inference_launches.get(kr["name"], 0)
        kr["mini_step_launches"] = sum(mini_launches.get(n, 0) for n in names)
        kr["small_run_launches"] = sum(small_launches.get(n, 0) + k11_launches.get(n, 0)
                                       for n in names)
        # on the layouts' forwards and steps; a sampling kernel's backward
        # counts with it, as its TPU function holds both
        kr["layouts_launches"] = sum(layout_launches.get(n, 0) for n in
                                     (names + [kr["name"] + "_bwd"] if kr["name"] in SAMPLING
                                      else names))
        kr["launches"] = (kr["inference_launches"] + kr["mini_step_launches"]
                          + kr["small_run_launches"] + kr["layouts_launches"])
        if kr["launches"] < 1:
            raise SystemExit(f"{kr['name']}: never launched on a main path")
    if len(kernels) != 14:
        raise SystemExit(f"{len(kernels)} kernel records, expected 14")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
