#!/usr/bin/env python3
"""Drive the PyTorch port's AFF-Mini semantic-segmentation paths -- inference
and the training step -- on one NVIDIA GPU.

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
5. holds each training kernel (local_attn and msdetrpc backward,
   point_sample forward and backward, the lapjv matcher) against its plain
   version at the shapes a 512x512 batch-8 training step gives it, and
   times both;
6. trains: the full-width step (batch 8, 512x512, 100 target slots, 12544
   points, fp32) on seeded synthetic label maps, once through the kernels
   and once through the plain versions from the same weights, batch and
   generator (loss terms, valid-target matches, gradient norms per
   parameter group), then 3 steps through the kernels with the launch
   counts of every kernel, ms per step for both paths and peak memory.

Exits non-zero on any failure, and at once when no CUDA device is present.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that lists the kernels with
their errors and times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SIZE, BATCH, SEED = 512, 4, 0
TRAIN_BATCH, TRAIN_STEPS = 8, 3
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


def grid_pos(side: int, step: int, b: int, dev):
    import torch

    ys, xs = torch.meshgrid(torch.arange(side), torch.arange(side), indexing="ij")
    pos = torch.stack([xs, ys], -1).reshape(1, -1, 2).float() * step
    return pos.expand(b, -1, -1).contiguous().to(dev)


def check_knn(dev, gen):
    """Every knn shape of one forward; indices and distances must be identical."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.knn import _knn_cuda, knn_plain

    cases = []   # (label, query, database, k)
    for s in range(4):                                  # backbone cluster neighbours
        b = 1 if s == 0 else BATCH                      # stage 1 runs on the constant grid
        pos, means, _, _, _ = space_filling_cluster(grid_pos(128 >> s, 1 << s, b, dev), 8, 128, 128)
        cases.append((f"cluster_s{s + 1}", pos, means, 6))
    for s in (1, 2):                                    # ClusterMerging 1-NN distance
        p = grid_pos(128 >> s, 1 << s, BATCH, dev)
        cases.append((f"merge_s{s + 1}", p, p, 2))
    q = grid_pos(128, 1, BATCH, dev)
    for lvl in (3, 2, 1):                               # pixel-decoder 4-NN tables, FPN
        cases.append((f"table_{128 >> lvl}", q, grid_pos(128 >> lvl, 1 << lvl, BATCH, dev), 4))
    cases.append(("fpn_shepard", q, grid_pos(64, 2, BATCH, dev), 4))
    # exact ties: integer queries exactly between half-integer database points
    cases.append(("tie_half_integer", q, grid_pos(64, 2, BATCH, dev) + 0.5, 4))

    ms, plain_ms = 0.0, 0.0
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
        log(f"  knn {label:18s} q={tuple(query.shape)} db={tuple(db.shape)} k={k}: "
            f"identical={same} kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        if not same:
            raise SystemExit(f"knn {label}: kernel and plain version disagree")
    return {"name": "knn", "route": "cuda", "source": "autofocusformermod_torch/csrc/knn.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/knn_kernel.py:136",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


def check_local_attn(dev, gen):
    """The four backbone stages' shapes; ms sums the 12 calls of a forward."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import sfc_cluster_attention

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    heads, dims, depths = (2, 4, 8, 16), (32, 128, 256, 384), (2, 2, 6, 2)
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for s in range(4):
        h, c_ = heads[s], dims[s] // heads[s]
        pos, means, _, _, _ = space_filling_cluster(grid_pos(128 >> s, 1 << s, 1, dev), 8, 128, 128)
        n = pos.shape[1]
        nc = knn(pos, means, 6).expand(BATCH, n, 6).contiguous()
        pos = pos.expand(BATCH, n, 2).contiguous()
        q = randn(BATCH, h, n, c_, scale=c_ ** -0.5)
        k, v = randn(BATCH, h, n, c_), randn(BATCH, h, n, c_)
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
        log(f"  local_attn stage {s + 1} q={tuple(q.shape)} nnc*span=48: max_abs_err {e:.3e} "
            f"(rel {e / rout.abs().max().item():.3e}) kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    if not err <= LOCAL_ATTN_ATOL:
        raise SystemExit(f"local_attn: max abs err {err} > {LOCAL_ATTN_ATOL}")
    return {"name": "local_attn", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/local_attn.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/local_attn.py:756",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_msdetrpc(dev, gen):
    """bh=32, 3 levels x 16 pairs, c_=32 at the three query levels; ms sums
    the 18 calls of a forward (6 encoder layers x 3 levels)."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.msdetrpc import msdetrpc_levels_s

    bh, p, c_, sizes = BATCH * 8, 16, 32, (256, 1024, 4096)
    val = torch.randn((bh, sum(sizes), c_), generator=gen).to(dev)
    err, ms, plain_ms = 0.0, 0.0, 0.0
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
        log(f"  msdetrpc n={n} idx={tuple(idx.shape)} val={tuple(val.shape)}: max_abs_err "
            f"{e:.3e} (rel {e / ref.abs().max().item():.3e}) kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms")
    if not err <= MSDETRPC_ATOL:
        raise SystemExit(f"msdetrpc: max abs err {err} > {MSDETRPC_ATOL}")
    return {"name": "msdetrpc", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/msdetrpc.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:2061",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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


def check_local_attn_bwd(dev, gen):
    """K2 at the four stages' shapes of a batch-8 step: the gradients of the
    kernel pair against the plain version's autograd; ms sums the 12
    backward calls of a step (the kernel backward alone vs the plain
    version's autograd backward alone)."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import (
        local_attn_forward, sfc_cluster_attention, sfc_cluster_attention_backward)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    heads, dims, depths, b = (2, 4, 8, 16), (32, 128, 256, 384), (2, 2, 6, 2), TRAIN_BATCH
    err, worst, ms, plain_ms = 0.0, 0.0, 0.0, 0.0
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
        log(f"  local_attn bwd stage {s + 1} q={tuple(q.shape)}: max_abs_err {e:.3e} (rel "
            f"{rel:.3e}; dq dk dv dw5 db5 dblank_k) kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    if not worst <= GRAD_RTOL:
        raise SystemExit(f"local_attn backward: max rel err {worst} > {GRAD_RTOL}")
    return {"name": "local_attn_bwd", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/local_attn.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/local_attn.py:622",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_msdetrpc_bwd(dev, gen):
    """K4 at a batch-8 step's shapes (bh=64, 3 levels x 16 pairs, c_=32);
    ms sums the 18 backward calls of a step."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.msdetrpc import (
        msdetrpc_levels_s, msdetrpc_levels_s_backward)

    bh, p, c_, sizes = TRAIN_BATCH * 8, 16, 32, (256, 1024, 4096)
    val = torch.randn((bh, sum(sizes), c_), generator=gen).to(dev)
    err, worst, ms, plain_ms = 0.0, 0.0, 0.0, 0.0
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
        log(f"  msdetrpc bwd n={n} idx={tuple(idx.shape)} val={tuple(val.shape)}: max_abs_err "
            f"{e:.3e} (rel {rel:.3e}; d_w d_val) kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    if not worst <= GRAD_RTOL:
        raise SystemExit(f"msdetrpc backward: max rel err {worst} > {GRAD_RTOL}")
    return {"name": "msdetrpc_bwd", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/msdetrpc.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:2078",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_point_sample(dev, gen):
    """K10 at a batch-8 step's three forward calls -- the ranking read
    (8000 masks x 37632 candidates), the target labels (800 512x512 masks x
    10 x 12544 points) and the matched logits (8000 x 12544) -- and the one
    backward (the logits'); ms sums the four."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.point_sample import (
        point_sample_backward, point_sample_bilinear)

    n_t, layers, pts = TRAIN_BATCH * 100, 10, 12544
    masks = torch.randn((layers * n_t, 128, 128), generator=gen).to(dev) * 3
    cases = (("ranking", masks, (layers * n_t, 3 * pts)),
             ("targets", None, (n_t, layers * pts)),
             ("logits", masks, (layers * n_t, pts)))
    fwd_err, bwd_err, bwd_rel, ms, plain_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    for label, m, (n, p) in cases:
        if m is None:
            m = (torch.rand((n, SIZE, SIZE), generator=gen) < 0.3).float().to(dev)
        coords = torch.rand((n, p, 2), generator=gen).to(dev)
        out = point_sample_bilinear(m, coords)
        with plain_versions():
            ref = point_sample_bilinear(m, coords)
            t_p = cuda_ms(lambda: point_sample_bilinear(m, coords), iters=3, warmup=1)
        t_k = cuda_ms(lambda: point_sample_bilinear(m, coords), iters=5, warmup=1)
        e = (out - ref).abs().max().item()
        fwd_err = max(fwd_err, e)
        ms, plain_ms = ms + t_k, plain_ms + t_p
        log(f"  point_sample fwd {label:8s} masks={tuple(m.shape)} points={p}: max_abs_err "
            f"{e:.3e} kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        del out, ref
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
            ms, plain_ms = ms + t_k, plain_ms + t_p
            log(f"  point_sample bwd {label:8s}: max_abs_err {bwd_err:.3e} (rel {bwd_rel:.3e}) "
                f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
            del got, want, leaf
        del coords
        torch.cuda.empty_cache()
    if not (fwd_err <= POINT_SAMPLE_ATOL and bwd_rel <= GRAD_RTOL):
        raise SystemExit(f"point_sample: forward err {fwd_err} > {POINT_SAMPLE_ATOL} or "
                         f"backward rel err {bwd_rel} > {GRAD_RTOL}")
    return {"name": "point_sample", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/point_sample.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/point_sample_kernel.py:200",
            "max_abs_err": max(fwd_err, bwd_err), "ms": ms, "plain_ms": plain_ms}


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
            "max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p}


def synthetic_batch(gen, dev, b: int, slots: int, num_classes: int):
    """uint8 images and blocky label maps with 8-12 classes each, labels
    padded to ``slots`` target slots as the semantic mapper pads them."""
    import torch

    images = torch.randint(0, 256, (b, SIZE, SIZE, 3), generator=gen, dtype=torch.uint8)
    sem = torch.zeros((b, SIZE, SIZE), dtype=torch.uint8)
    labels = torch.zeros((b, slots), dtype=torch.long)
    valid = torch.zeros((b, slots), dtype=torch.bool)
    for i in range(b):
        k = int(torch.randint(8, 13, (1,), generator=gen))
        classes = torch.randperm(num_classes, generator=gen)[:k]
        cells = classes[torch.randint(0, k, (16 * 16,), generator=gen)]
        cells[:k] = classes                                # every class present
        cells = cells[torch.randperm(16 * 16, generator=gen)].reshape(16, 16)
        sem[i] = cells.repeat_interleave(SIZE // 16, 0).repeat_interleave(SIZE // 16, 1)
        present = torch.unique(sem[i]).long()
        labels[i, :len(present)] = present
        valid[i, :len(present)] = True
    return {"image": images.to(dev), "sem_seg_map": sem.to(dev), "labels": labels.to(dev),
            "valid": valid.to(dev)}


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
                            cfg.TPU.MAX_GT_INSTANCES, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
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
    p_times, _, p_peak = timed_steps(plain_versions, 2)
    k_ms = statistics.median(times[1:]) * 1e3
    p_ms = p_times[-1] * 1e3
    log(f"  ms per step (steady): kernels {k_ms:.1f} ({TRAIN_BATCH / k_ms * 1e3:.2f} images/s, "
        f"peak {peak:.2f} GiB), plain versions {p_ms:.1f} ({TRAIN_BATCH / p_ms * 1e3:.2f} "
        f"images/s, peak {p_peak:.2f} GiB) ({smi})")
    log(f"  launches over {TRAIN_STEPS} steps: {launches}")
    return launches


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
    from autofocusformermod_torch.ops.point_sample import point_sample_backward, point_sample_bilinear

    dev = torch.device("cuda", 0)
    log("phase 1: build")
    t0 = time.time()
    lib_path = build_library()
    load_kernels()
    log(f"  built {lib_path.name} in {time.time() - t0:.1f} s")

    log("phase 2: kernels against their plain versions, 512x512 batch-4 shapes")
    gen = torch.Generator().manual_seed(SEED)
    kernels = [check_local_attn(dev, gen), check_msdetrpc(dev, gen), check_knn(dev, gen)]

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
    for kr in kernels:
        kr["launches"] = launches[kr["name"]]
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

    log(f"phase 5: training kernels against their plain versions, 512x512 batch-{TRAIN_BATCH} "
        "step shapes")
    kernels += [check_local_attn_bwd(dev, gen), check_msdetrpc_bwd(dev, gen),
                check_point_sample(dev, gen), check_lapjv(dev, gen)]
    torch.cuda.empty_cache()

    log(f"phase 6: AFF-Mini training step, 512x512, batch {TRAIN_BATCH}, fp32, seeded random "
        "weights and label maps")
    train_counters = {"local_attn": sfc_cluster_attention,
                      "local_attn_bwd": sfc_cluster_attention_backward,
                      "msdetrpc": msdetrpc_levels_s, "msdetrpc_bwd": msdetrpc_levels_s_backward,
                      "point_sample": point_sample_bilinear,
                      "point_sample_bwd": point_sample_backward, "lapjv": lapjv, "knn": knn}
    per_step = {"local_attn": 12, "local_attn_bwd": 12, "msdetrpc": 18, "msdetrpc_bwd": 18,
                "point_sample": 3, "point_sample_bwd": 1, "lapjv": 1, "knn": 10}
    train_launches = train_phase(dev, smi, train_counters)
    for name, n in per_step.items():
        if train_launches[name] != n * TRAIN_STEPS:
            raise SystemExit(f"{name}: launched {train_launches[name]} times in {TRAIN_STEPS} "
                             f"training steps, expected {n} per step")
    for kr in kernels:
        kr["inference_launches"] = kr.get("launches", 0)
        kr["launches"] = train_launches[kr["name"]]
        if kr["name"] == "point_sample":
            kr["launches"] += train_launches["point_sample_bwd"]

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
