#!/usr/bin/env python3
"""Drive the PyTorch port's segmentation paths -- AFF-Mini inference, the
AFF-Mini training step, an AFF-Small training run with checkpoint and
resume, the pixel decoder's alternate operand layouts, the AFF-Mini-1/5
preset, MaskFiner-Mini inference, training from the dataset loader with
evaluation, MaskFiner-Mini training, Cityscapes-panoptic and
COCO-instance training and evaluation, the Swin-B and R50 grid
baselines, the MaskFiner-UpDown-Mini (OracleTeacher-BB) cascade, and the
JAX package's flagship trained at its decoder dropout with the AFF and
MaskFiner variants, and the XAttn / ConvNeXtV2 cascade with the dynamic
split ratios and the other assignment backends -- on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels (csrc/) with nvcc, one process per
   source;
2. holds each inference kernel against its plain PyTorch version on the
   card, at the shapes a 512x512 batch-4 forward gives it, and times both
   (msdetrpc also at other levels, pairs and widths: its generic instance;
   knn on both its routes, bit for bit, at grid positions and at the
   positions of a real seeded forward, each call's route and time on the
   card under "by_case");
3. runs the full AFF-Mini + Mask2Former forward (published ADE20K widths,
   seeded random weights) at 512x512, batch 4, through the kernels, checks
   that every kernel launched the expected number of times (knn on the
   routes its shapes give), and compares the outputs with the same model run
   through the plain versions, which replay the kernel run's discrete
   choices (kept tokens, sampling cells, attention masks) and count how
   many of them they would have made otherwise;
4. serves 8 random uint8 512x512 images through the predictor at batch 1
   and batch 4 and checks the label maps;
5. holds every kernel of a training step against its plain version at the
   shapes a 512x512 batch-8 step of each trained model gives it, and times
   both: local_attn forward and backward at AFF-Mini's and at AFF-Small's
   stage shapes (the forward also on the card alone; the backward's two
   kernels timed apart, its reverse lists' build timed too, two calls
   compared bit for bit; both once more on random neighbour lists), and what
   is the same for both models at one batch (msdetrpc forward and backward,
   each on a uniform draw and on the operands of a real batch-8 forward, the
   backward two calls bit for bit, both beside F.embedding_bag, the forward
   against the least time the card's L2 needs for its value rows; knn;
   point_sample forward and backward on each route, on uniform coordinates
   and on those of a real batch-8 criterion call, beside F.grid_sample; the
   lapjv matcher on both its routes, bit for bit, on a uniform draw and on
   the costs of a real batch-8 criterion call, with the plain version's
   Dijkstra step counts, and on NaN / inf costs under a time limit);
6. trains: the full-width AFF-Mini step (batch 8, 512x512, 100 target slots,
   12544 points, fp32, the default criterion with the nearest-tap ranking)
   on seeded synthetic label maps, once through the kernels and once
   through the plain versions from the same weights, batch and generator
   (loss terms, valid-target matches, gradient norms per parameter group),
   then 3 steps through the kernels with the launch counts of every kernel,
   ms per step for both paths and peak memory;
7. holds the two nearest-read kernels of the point ranking against their
   plain versions (exact equality: they copy floats) at the step's shapes,
   K11 also on its direct route (256x256 masks), times them beside one flat
   torch.gather (K11 also on the card alone, with the route it took: every
   K11 hold of phases 7, 9, 13 and 15 is appended to
   chiprun_out/k11_holds.jsonl), and checks that the whole
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
   step, the four msdetrpc kernels also on the operands of real batch-8
   steps under their layout's flag (the interleaved one at 384x384 and of
   the AFF-Mini-1/5 preset at 512x512), beside F.embedding_bag on their
   operands relaid to the stacked form, and the fixed-order backwards
   twice, bit for bit; runs the phase-3 forward (same weights and images) once per layout
   and compares launch counts and outputs with the default layout's, with
   ms per forward and device busy ms of each; the same at 384x384, where the
   decoder's levels are not all multiples of 128, through the interleaved
   kernel; and one batch-8 training step per layout (and a batch-2 step at
   384x384 for the interleaved one) against the default layout's step from
   the same weights, batch and generators, each step's point ranking read
   on the route its masks give (K12 on 128-wide masks, K11 on the 96-wide
   ones of 384x384, held on that step's operands);
10. the published AFF-Mini-1/5 preset (cluster merging keeps a fifth of the
   tokens: decoder levels of 3276, 655 and 131 tokens, clusters cut by n) at
   512x512: a batch-4 forward and a batch-8 training step, in the default
   layout and with USE_STACKED_GLUE off (the interleaved kernel), each
   against the plain versions from the same weights, images, batch and
   generators, replaying the discrete choices as in phase 3 (also the
   ranked points and the matches), with every kernel's launch counts and
   device busy per forward;
11. the published MaskFiner-Mini cascade (MixRes backbones, per-stage pixel
   and mask decoders; stages of 256, 768, 1792 and 3840 tokens) at 512x512:
   holds local_attn, msdetrpc and knn against their plain versions on the
   operands of a real batch-4 forward (each call; one- to three-level
   sampling tables, heads of 16 and 32 channels, self-knn with k 9), runs
   the forward through the kernels (launch counts from the config) and
   through the plain versions, replaying the kernel run's choices (also the
   split tokens and the queries' class votes), holds the final and every
   aux output to FORWARD_RTOL, every stage's disagreement through its parts
   (the classes' summed mask logits to FORWARD_RTOL; the mean and the mean
   absolute difference of their sigmoids and the disagreement itself to
   the bounds the logits' differences set) and the last stage's positions
   to equality, times both forwards with device busy, and
   serves 8 random uint8 512x512 images through the predictor at batch 1
   and 4;
12. evaluation and the dataset path, through the package's command line in
   this process, on 12 image and label-map pairs made from a numpy seed at
   ADE20K's aspect ratios (the mapper's two file readers replaced by
   lookups, as the card's machine has no PIL): AFF-Mini (one block a stage,
   ONE_BLOCK_AFF) trained 4 steps at
   batch 8 from TrainLoader (the mapper's resize, crop, colour jitter, flip
   and padding) with test() after steps 2 and 4, then --eval-only on the
   checkpoint, which must equal the in-loop test(); the loader's batches,
   the pad fringe of the model's input in test() (the rounded pixel mean),
   K1, K3 and K9 launches per test image, and a confusion matrix that
   counts every labelled ground-truth pixel at the original size; the
   test() images once more through the plain versions, replaying the kernel
   run's choices (class scores to FORWARD_RTOL, predictions equal but at
   near-tied pixels, metrics within what those pixels can move, and
   verify_results); ms per image by padded size (up to 512x2048, 65,536
   first-stage tokens); MaskFiner-Mini (one block a stage) --eval-only on
   two images;
13. the published MaskFiner-Mini cascade's training step at 512x512, batch
   4 (100 target slots, 12544 points, the loss weights of MODEL.MASK_FINER,
   19 supervised outputs at masks of 16x16, 32x32, 64x64 and 128x128):
   holds the local_attn backward, the msdetrpc backward, point_sample
   forward and backward for each mask shape, the two nearest reads of the
   ranking (i.i.d. on the 16-, 32- and 64-wide masks, stratified on the
   128-wide ones) and the lapjv matcher against their plain versions on the
   operands of a real step; 3 steps through the kernels, each replayed
   through the plain versions from the same weights and optimizer state
   (loss terms, gradient norms per group, each stage's disagreement through
   its parts), with every kernel's launches per step from the config, ms
   per step, device busy and peak memory; the package's command line for 4
   steps, and a run stopped after step 2 and resumed to step 4 with test()
   on two in-memory images at its end.

14. panoptic and instance segmentation through the package's command line
   in this process, on seeded in-memory data (the mappers' file readers
   replaced by lookups): the published AFF-Mini Cityscapes-panoptic preset
   (one block a stage, ONE_BLOCK_AFF) trained 3 steps at batch 4 on
   512x1024 crops from the panoptic mapper
   (Cityscapes-shaped image / panoptic-id pairs: stuff, thing instances, a
   crowd segment, a void band), then test() with PQ over the test set at
   1024x2048, --eval-only on the checkpoint, and test() at the seeded
   initial weights against ground truth made from their own predictions
   (a random model keeps no query at 0.8); the AFF-Mini COCO-instance preset trained 2 LSJ steps at
   1024x1024, batch 2, on COCO-sized images with polygon, RLE, compressed
   RLE and crowd annotations, then test() with COCO mask AP at 800x1333;
   launches per step and per test image, PQ / SQ / RQ and AP, images/s, ms
   per image by size, device busy and peak memory; a 1024x2048 and a
   COCO-sized test image through the kernels and through the plain
   versions (replaying the choices): outputs to FORWARD_RTOL, the panoptic
   maps and segments and the instance pairs, scores and masks equal but
   where near-tied; K1, K3 and K9 on the operands of the 1024x2048 forward
   (131,072 first-stage tokens); K2, K4, K10 (the shared route on 128x256
   masks, the direct one on 256x256), K12 at width 256 and K13 on the
   targets of a real step of each preset, and that step replayed through
   the plain versions.

15. the grid baselines at their published widths and depths (seeded
   random weights): Swin-B-384 (MaskFormerSwin: the Swin backbone, the grid
   deformable pixel decoder, the grid attention mask) at 640x640 and
   Mask2Former-R50 (the ResNet under the point-cloud pixel decoder) at
   512x512: a forward of each (Swin-B at batch 2; the R50 at batch 4
   against the plain versions, replaying the choices), the kernels on the
   operands of a real step of each (the R50's K3, K4 and K9 on full-grid
   levels of 4096, 1024 and 256 tokens; K10 on Swin-B's 160x160 logits and
   640x640 targets, K11 ranking its 160-wide masks; K12, K13), 3 Swin-B
   steps at its published batch of 2 and 2 R50 steps at batch 8, each
   replayed through the plain versions, and test() over ADE20K-shaped
   images at short edge 640 (one wider than 2048) and 512, with launches
   per forward, step and test image, ms, peak memory, device busy and
   images/s.

16. the published MaskFiner-UpDown-Mini (MaskFinerOracleTeacherBB: an
   UpDownBackbone of 7 MixRes stages, down-stage segments of 256, 868, 2428
   and 5824 tokens at 512x512, the final stage's pixel decoder and the
   dense OracleTeacher decoder on a 128x128 grid) at 512x512: K1, K3 and K9
   on the operands of a real batch-4 forward, the forward against the
   plain versions (replaying the choices), K2, K4, K10, K12 and K13 on a
   real step's operands, 2 steps at batch 4 with the upsampling loss, each
   replayed through the plain versions, and test() on two ADE20K-shaped
   images, then under MaskFinerOracleTeacherSW (sliding windows); times to
   chiprun_out/updown_phase16.json.

17. the last two published model families at 512x512 (seeded random
   weights): the OracleTeacher cascade (MaskFinerOracleTeacher: four
   256-wide MixRes stages, streams of 256, 868, 2336 and 5856 tokens, the
   projection decoders and score MLPs of stages 0-2, the leaky pixel
   decoder and the dense decoder of the last; teacher ratio 0.8) and
   MRML-NB-Mini (MaskFormerML over MixResMetaLossNeighbour: cluster
   attention over streams of 256, 832, 2560 and 7744 tokens, the Up pixel
   decoder, the meta loss), each with K1, K3 and K9 on the operands of a
   real batch-4 forward, the forward against the plain versions
   (replaying the choices), K2, K4, K10, the ranking's read and K13 on a
   real step's operands, 2 steps at batch 4 each replayed through the
   plain versions (loss_upsampling or meta_loss finite and above 0), and
   test() on two ADE20K-shaped images; MRML-Mini (MaskFormerML, global
   attention over 256-832 tokens) and MRMean-Mini (MaskFormer over
   MixResMeanAct, the plain decoder) a forward and a step each against
   the plain versions; launches per forward, step and test image from the
   config (family_launches), times to chiprun_out/phase17.json.

19. bf16 mixed precision at the published COCO-panoptic UpDown-Tiny (see
   amp_phase); times to chiprun_out/phase19.json.

20. four published yamls read by the port's own yaml reader (PyYAML neither
   imported nor needed) and trained through `train_net --config-file` at
   their published widths and depths (batches cut): the COCO-panoptic
   MaskFiner cascade under AMP at 1024x1024, MaskFiner-Large at 512x512,
   Cityscapes AFF-Base-384 at 512x1024 (K1 and K2 on 144-slot
   neighbourhoods) and Cityscapes UpDown-Base SW at its 1024x1024 crops:
   2 steps each, the trained model's forward against the plain versions
   (replaying the choices), a step's device busy time, the demo on one
   image of the yaml's test size, the sliding-window test() on a 1024x2048
   image, the analysis tool's parameter count; on AFF-Base-384 also K1, K3
   and K9 on the operands of a forward and K2, K4, K10, K12 and K13 on
   those of a real step, each against its plain version; launches from
   the config (yaml_launches), times to chiprun_out/phase20.json.

21. data parallelism: two ranks on the one card (gloo over an explicit
   device map: NCCL takes one rank a device) each take two steps of the
   published AFF-Mini at 512x512, batch 4, through Trainer / TrainStep
   (DistributedDataParallel, the global BatchNorm statistics and
   criterion, the global batch's draws cut to each rank's rows), held
   against one process's two steps on the global batch of 8 whose discrete
   choices they replay, cut to their rows (loss terms, grad_norm, the
   update's norm per parameter group, the stem's BatchNorm statistics, one
   model on both ranks), each rank's launches counted (distributed_launches);
   then train_net under a torchrun-style environment of one process
   (WORLD_SIZE=1: an NCCL group, the DDP wrapper, the evaluators' merge)
   for 2 steps and --eval-only on two images; times to
   chiprun_out/phase21.json.

22. what the ported models refused or ignored until then (see
   dropout_phase): the JAX package's flagship trained at its decoder
   dropout 0.1 as bench.py trains it (AMP, 512x512, batch 8, 2 steps),
   AFF-Mini without the reserved grid at a 64-token span, and MaskFiner-Mini
   with the pre-norm Cat decoder, MASK_DECODER_ALL_LEVELS, a HierUp stage and
   its stage dropouts; every step replayed through the plain versions, each
   Dropout's kept share held; times to chiprun_out/phase22.json.

23. the stages and backends the port once refused (see xattn_phase):
   MaskFiner-Mini at its published widths with a ConvNeXtV2 first stage and
   MixResNeighbourXAttn stages (K1, K3, K9 on a batch-4 forward's operands,
   the forward and one Trainer step against the plain versions), a
   MixResNeighbour first stage, the eval-time dynamic split ratios, the
   auction against the lapjv kernel, the downsampled criterion against the
   CPU and the demo's AsyncPredictor; each kernel's launches there as
   xattn_launches; times to chiprun_out/phase23.json.

Phases 6, 8, 9, 10, 13, 14, 15, 16 and 17 compare training steps whose second run replays
the first run's discrete choices (same_choices), held to LOSS_RTOL and
GROUP_NORM_RTOL.

Exits non-zero on any failure, and at once when no CUDA device is present.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that lists the kernels with
their errors, times, launch counts, bounds and (where one PyTorch call
computes the same function) that call's time; a kernel held at the shapes of
several paths has each path's figures under "by_path".
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
# gradient tensor: the point_sample backward scatters with atomics (run-to-run
# order; the local_attn pair and every msdetrpc backward sum in a fixed order,
# another than the plain version's) and the w5/b5 reductions sum ~1e6 terms in
# another order
GRAD_RTOL = 1e-3
# a forward whose plain run replays the kernel run's discrete choices
# (same_choices): each output's max abs error, relative to its largest
# |entry| (at least 1); the kernels sum in another order than the plain
# versions (seen: 1.0e-6 on the logits, 3.9e-6 to 4.4e-6 on the masks,
# phases 3 and 10)
FORWARD_RTOL = 1e-4
# the share of each discrete choice's elements that the plain run, made
# beside the replayed choice, makes as the kernel run did (kept tokens and
# ranked points as sets per row): near-tied scores flip between the two
# orders of summation, a kernel that moves many choices fails.  Seen, worst
# of phases 3 and 10: kept tokens 1 of 21504 flipped, sampling cells 20 of
# 1.9e7, attention masks 64 of 7.9e7, ranked points 275 of 7.5e7, matches 2
# of 8000 (target slots, padded ones included).  The MaskFiner cascade
# (phase 11) adds the order of its split tokens (an element of the
# ascending order counts where it equals) and the class each query votes
# for in its disagreement; the MRML backbone (phase 17) the order of its
# split and kept tokens, which its meta-loss scores set (a forward holds
# those scores and logs the order; a step floors it)
CHOICE_AGREE_MIN = {"kept tokens": 0.999, "sampling cells": 0.9999, "attention masks": 0.9999,
                    "ranked points": 0.9999, "matches": 0.99, "split tokens": 0.999,
                    "class votes": 0.999, "meta-loss split": 0.99}
# phase 17's models at random initialisation flip more matches and ranked
# points than those floors allow (seen: MRMean-Mini's step 103 of 4000
# matches, MRML-Mini's 6792 of 3.8e7 ranked points).  There, and only
# there (same_choices near_ties), a kind under its floor passes if it stays
# at or above this lower floor and every flip is one the two runs' scores
# explain: the recorded choice costs no more than the plain run's own, under
# the plain run's scores, than the scores of the choices involved differ
# between the runs (same_choices.near_tie)
NEAR_TIE_AGREE_MIN = {"matches": 0.95, "ranked points": 0.999, "class votes": 0.999}
# an exact assignment solved in fp32 is optimal to a few units in the last
# place of its summed cost
NEAR_TIE_ROUNDING = 1e-6
# a training step whose plain run replays the kernel run's choices
# (phases 6, 8, 9, 10): loss terms and gradient norms per parameter group,
# relative.  The kernels' sums in another order (and the atomics of the
# point_sample backward) are all that is left (seen, phase 10 of the
# AFF-Mini-1/5 preset: loss terms 3.0e-7, gradient norms 7.5e-6)
LOSS_RTOL = 1e-5
GROUP_NORM_RTOL = 1e-4
# the rounding of a MaskFiner disagreement's parts (sums over up to 151^2
# class pairs), beyond what its inputs' differences allow
# (check_disagreement)
GINI_ROUNDING_ATOL = 1e-5
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


STARTED = time.time()


def log(msg: str) -> None:
    """Print a line: a phase's first line says when the phase began, every
    other line starts with the seconds since the script started."""
    if msg.startswith("phase "):
        msg = f"{msg} [{time.time() - STARTED:.1f} s into the script]"
    else:
        msg = f"[{time.time() - STARTED:7.1f}] {msg}"
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


def knn_grid_cases(dev, gen, batch):
    """[(label, query, database, k)]: every knn shape of one forward at this
    batch (the same for both models) on grid positions, each database in a
    random order (ties go by index), and one case of exact ties."""
    import torch
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster

    cases = []
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
    out = []
    for label, query, db, k in cases:
        perm = torch.randperm(db.shape[1], generator=gen).to(dev)   # tie order by index
        out.append((label, query.contiguous(), db[:, perm].contiguous(), k))
    return out


def check_knn(label, cases):
    """K9 on the calls of one forward, `cases` [(case, query, database, k)]
    (knn_grid_cases or path_knn_operands): on every route, indices and
    distances must equal the plain version's.  ms and device_ms (the card's
    time alone, queued_ms) sum the calls on the routes the wrapper picks;
    `by_case` has each call's route and times, and the sweep's device time
    beside the pruned route's where the pruned one is taken.  The bound is
    the bytes: a pruned search need not evaluate every pair, so the brute
    force's operations are no longer its least work (`pairs_bound_ms` keeps
    that figure: 5 operations a pair)."""
    import torch
    from autofocusformermod_torch.geometry.knn import ROUTES, _knn_cuda, knn_plain, knn_route

    ms = device_ms = plain_ms = 0.0
    bnd, pairs_bnd, by_case = {}, {}, {}
    for case, query, db, k in cases:
        ridx, rd2 = knn_plain(query, db, k)
        for route in ROUTES:
            idx, d2 = _knn_cuda(query, db, k, route=route)
            torch.cuda.synchronize()
            if not (torch.equal(idx, ridx) and torch.equal(d2, rd2)):
                raise SystemExit(f"knn {label} {case} ({route} route): kernel and plain version "
                                 "disagree")
        route = knn_route(db.shape[1])
        rec = {"route": route, "ms": cuda_ms(lambda: _knn_cuda(query, db, k)),
               "device_ms": queued_ms(lambda: _knn_cuda(query, db, k))}
        if route != "sweep":
            rec["sweep_device_ms"] = queued_ms(lambda: _knn_cuda(query, db, k, route="sweep"))
        t_p = cuda_ms(lambda: knn_plain(query, db, k), iters=5, warmup=1)
        on_path = case != "tie_half_integer"
        if on_path:
            ms, device_ms, plain_ms = ms + rec["ms"], device_ms + rec["device_ms"], plain_ms + t_p
            bnd = add_bounds(bnd, bound(nbytes(query, db, ridx, rd2), 0))
            pairs = query.shape[0] * query.shape[1] * db.shape[1]
            pairs_bnd = add_bounds(pairs_bnd, bound(0, 5 * pairs))
        by_case[case] = rec
        log(f"  knn {label} {case:18s} q={tuple(query.shape)} db={tuple(db.shape)} k={k}: "
            f"identical on {ROUTES}; {route} {rec['ms']:.4f} ms, on the card "
            f"{rec['device_ms']:.4f} ms" + (f" (sweep {rec['sweep_device_ms']:.4f})"
                                             if route != "sweep" else "")
            + f", plain {t_p:.4f} ms" + ("" if on_path else " [not on the path]"))
    log(f"  knn {label}: per forward {ms:.4f} ms, on the card {device_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms (every pair: {pairs_bnd['bound_ms']:.4f})")
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, **bnd,
            "pairs_bound_ms": pairs_bnd["bound_ms"], "by_case": by_case}


def knn_record(paths: dict) -> dict:
    return {"name": "knn", "route": "cuda", "source": "autofocusformermod_torch/csrc/knn.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/knn_kernel.py:136",
            "library_ms": None, "device_ms": paths["b4_forward"]["device_ms"],
            **per_path(paths, "b4_forward")}


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


def msdetrpc_uniform_calls(dev, gen, b, times=6):
    """K3 and K4 operands at batch b (bh = 8 b; the pixel decoder is the same
    for both models) drawn uniformly: 3 levels x 16 pairs, c_=32, one call
    per query level (n = 256, 1024, 4096), each standing for `times` calls (6
    encoder layers).  -> [(idx_s, w_s, val, level sizes, times)]."""
    import torch

    bh, p, c_, sizes = b * 8, 16, 32, (256, 1024, 4096)
    val = torch.randn((bh, sum(sizes), c_), generator=gen).to(dev)
    calls = []
    for n in sizes:
        idx = torch.cat([torch.randint(0, s, (bh, n, p), generator=gen) for s in sizes], 2)
        w = torch.rand((bh, n, 3 * p), generator=gen)
        calls.append((idx.int().to(dev).contiguous(),
                      (w / w.sum(-1, keepdim=True)).to(dev).contiguous(), val, sizes, times))
    return calls


def check_msdetrpc(label, calls, l2_rate=None):
    """K3 on `calls` [(idx_s, w_s, val, level sizes, times)], each against the
    plain version within MSDETRPC_ATOL; ms sums the calls, each `times` times
    (a forward's 18).  Times: the kernel in calls (cuda_ms) and on the card
    alone (device_ms, queued_ms); the plain version; the library call
    (F.embedding_bag on its rows made ahead) and, apart, the making of its
    rows (msdetrpc_bag_rows).  With the L2 read rate, l2_rows_ms is the least
    time in which the card's L2 serves every query's L*P value rows."""
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.msdetrpc import (
        msdetrpc_bag_rows, msdetrpc_levels_s, msdetrpc_levels_s_library)

    err, lib_err, ms, device_ms, plain_ms, lib_ms, rows_ms, row_bytes, bnd = (
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, {})
    for idx, w, val, sizes, times in calls:
        bh, n, lp = idx.shape
        c_ = val.shape[2]
        out = msdetrpc_levels_s(idx, w, val, sizes)
        with plain_versions():
            ref = msdetrpc_levels_s(idx, w, val, sizes)
            t_p = cuda_ms(lambda: msdetrpc_levels_s(idx, w, val, sizes), iters=5, warmup=1)
        t_k = cuda_ms(lambda: msdetrpc_levels_s(idx, w, val, sizes))
        d_k = queued_ms(lambda: msdetrpc_levels_s(idx, w, val, sizes))
        rows = msdetrpc_bag_rows(idx, sizes)
        t_r = cuda_ms(lambda: msdetrpc_bag_rows(idx, sizes), iters=5, warmup=1)
        lib = msdetrpc_levels_s_library(idx, w, val, sizes, rows=rows)
        t_l = cuda_ms(lambda: msdetrpc_levels_s_library(idx, w, val, sizes, rows=rows))
        e = (out - ref).abs().max().item()
        err, lib_err = max(err, e), max(lib_err, (lib - ref).abs().max().item())
        ms, device_ms, plain_ms = ms + times * t_k, device_ms + times * d_k, plain_ms + times * t_p
        lib_ms, rows_ms = lib_ms + times * t_l, rows_ms + times * t_r
        row_bytes += times * bh * n * lp * c_ * 4
        # a multiply and an add per (query, pair, channel)
        bnd = add_bounds(bnd, bound(nbytes(idx, w, val, out), 2 * bh * n * lp * c_), times)
        log(f"  msdetrpc {label} n={n} idx={tuple(idx.shape)} val={tuple(val.shape)}: "
            f"max_abs_err {e:.3e} (rel {e / ref.abs().max().item():.3e}) kernel {t_k:.4f} ms "
            f"(on the card {d_k:.4f}), plain {t_p:.4f} ms, embedding_bag {t_l:.4f} ms (+ rows "
            f"{t_r:.4f})")
        del out, ref, rows, lib
    if not err <= MSDETRPC_ATOL:
        raise SystemExit(f"msdetrpc {label}: max abs err {err} > {MSDETRPC_ATOL}")
    if not lib_err <= MSDETRPC_ATOL:
        raise SystemExit(f"msdetrpc_levels_s_library {label}: max abs err {lib_err}")
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "device_ms": device_ms,
           "library_ms": lib_ms, "library_rows_ms": rows_ms, "row_bytes": row_bytes}
    if l2_rate:
        rec["l2_rows_ms"] = row_bytes / l2_rate * 1e3
    log(f"  msdetrpc {label}: {ms:.3f} ms in calls, {device_ms:.3f} on the card; embedding_bag "
        f"{lib_ms:.3f} (+ rows {rows_ms:.3f}); bound {bnd['bound_ms']:.3f} ms; value rows "
        f"{row_bytes / 1e9:.2f} GB" + (f", {rec['l2_rows_ms']:.3f} ms at the L2 rate"
                                       if l2_rate else ""))
    return rec


# the generic instance of K3: levels, pairs and channels other than the
# path's (3, 16, 32), level sizes not multiples of 8, and a c_ read 4 bytes a
# lane
MSDETRPC_GENERIC_CASES = ((16, 300, (37, 150, 613), 8, 24), (4, 97, (11, 29), 5, 5))


def check_msdetrpc_generic(dev, gen):
    """K3 on its generic instance (run-time levels and pairs), against the
    plain version within MSDETRPC_ATOL.  -> max abs err."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.msdetrpc import msdetrpc_levels_s

    err = 0.0
    for bh, n, sizes, p, c_ in MSDETRPC_GENERIC_CASES:
        val = torch.randn((bh, sum(sizes), c_), generator=gen).to(dev)
        idx = torch.cat([torch.randint(0, s, (bh, n, p), generator=gen) for s in sizes], 2)
        idx = idx.int().to(dev).contiguous()
        w = torch.rand((bh, n, len(sizes) * p), generator=gen).to(dev)
        out = msdetrpc_levels_s(idx, w, val, sizes)
        with plain_versions():
            ref = msdetrpc_levels_s(idx, w, val, sizes)
        e = (out - ref).abs().max().item()
        log(f"  msdetrpc generic instance: bh {bh}, n {n}, levels {sizes}, {p} pairs, c_ {c_}: "
            f"max_abs_err {e:.3e}")
        err = max(err, e)
    if not err <= MSDETRPC_ATOL:
        raise SystemExit(f"msdetrpc generic instance: max abs err {err} > {MSDETRPC_ATOL}")
    return err


def msdetrpc_record(paths: dict) -> dict:
    return {"name": "msdetrpc", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/msdetrpc.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:2061",
            "library_ms": paths["b4_forward"]["library_ms"], **per_path(paths, "b4_forward")}


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


def check_msdetrpc_bwd(dev, gen, path_calls):
    """K4 at a batch-8 step's shapes (bh=64, 3 levels x 16 pairs, c_=32) on
    two index sets: the uniform draw of earlier records, and the path's own
    operands (`path_calls`, from path_msdetrpc_operands: the 18 calls of a
    batch-8 AFF-Mini forward), whose figures are the record's own; each
    held by msdetrpc_bwd_calls with random gradients."""
    import torch

    sets = {"uniform": msdetrpc_uniform_calls(dev, gen, TRAIN_BATCH), "path": path_calls}
    paths = {}
    for label in list(sets):
        paths[label] = msdetrpc_bwd_calls(label, sets.pop(label), gen)   # freed after its turn
        torch.cuda.empty_cache()
    return {"name": "msdetrpc_bwd", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/msdetrpc.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:2078",
            "library_ms": paths["path"]["library_ms"], "deterministic": True,
            **per_path(paths, "path")}


def msdetrpc_bwd_calls(label, calls, gen):
    """K4 on `calls` [(idx_s, w_s, val, level sizes, times[, g])], g the
    output's gradient (random where the call has none): each against the
    plain version's autograd, and twice, bit for bit (the kernels sum in a
    fixed order).  ms sums the calls, each `times` times; device_ms the same
    on the card alone (queued_ms); library_ms the autograd backward of
    msdetrpc_levels_s_library (F.embedding_bag) on the same operands."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.msdetrpc import (
        msdetrpc_bag_rows, msdetrpc_levels_s, msdetrpc_levels_s_backward,
        msdetrpc_levels_s_library)

    err, worst, ms, device_ms, plain_ms, lib_ms, bnd = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, {}
    for idx, w, v, lv_sizes, times, *given in calls:
        bh, n, lp = idx.shape
        c_ = v.shape[2]
        g = given[0] if given else torch.randn((bh, n, c_), generator=gen).to(v.device)
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
        rows = msdetrpc_bag_rows(idx, lv_sizes)
        lib_out = msdetrpc_levels_s_library(idx, leaves[0], leaves[1], lv_sizes, rows=rows)
        t_l = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True))
        ms, device_ms, plain_ms = ms + times * t_k, device_ms + times * d_k, plain_ms + times * t_p
        lib_ms += times * t_l
        # d_val += w * g and d_w = g . val: 4 operations per (query, pair, channel)
        bnd = add_bounds(bnd, bound(nbytes(idx, w, v, g, w, v), 4 * bh * n * lp * c_), times)
        log(f"  msdetrpc bwd {label} n={n} idx={tuple(idx.shape)} val={tuple(v.shape)}: "
            f"max_abs_err {e:.3e} (rel {rel:.3e}; d_w d_val), bit-identical twice; kernel "
            f"{t_k:.4f} ms (on the card {d_k:.4f}), plain {t_p:.4f} ms, embedding_bag's "
            f"backward {t_l:.4f} ms")
        del g, leaves, got, want, first, again, rows, lib_out
    if not worst <= GRAD_RTOL:
        raise SystemExit(f"msdetrpc backward ({label}): max rel err {worst} > {GRAD_RTOL}")
    log(f"  msdetrpc bwd {label}: per step {ms:.3f} ms in calls, {device_ms:.3f} on the card, "
        f"embedding_bag's backward {lib_ms:.3f}, bound {bnd['bound_ms']:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "device_ms": device_ms,
            "library_ms": lib_ms}


def seeded_step(dev, b, module, name, capture, preset="aff_mini", size=SIZE):
    """One batch-b training step of `preset` at size x size (seeded weights,
    label maps and draws) with `module.name` replaced by capture(real) for
    the step; the model and batch are freed after it."""
    import torch
    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.data.synthetic import synthetic_batch
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses import criterion
    from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config

    cfg = PRESETS[preset]()
    model = maskformer_from_config(cfg)
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    batch = synthetic_batch(torch.Generator().manual_seed(SEED + 1), dev, b, (size, size),
                            cfg.TPU.MAX_GT_INSTANCES, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    real = getattr(module, name)
    setattr(module, name, capture(real))
    try:
        TrainStep(model, cfg).loss_and_grads(
            batch, criterion.device_draw(torch.Generator(device=dev).manual_seed(SEED)))
    finally:
        setattr(module, name, real)
    del model, batch
    torch.cuda.empty_cache()


def path_point_sample_operands(dev, b=TRAIN_BATCH):
    """The operands of K10's calls in one batch-b AFF-Mini training step at
    512x512 (seeded weights, label maps and draws), as the criterion makes
    them: {"targets": (masks, coords)}, the target labels' forward (b * 100
    512x512 masks, 10 layers x 12544 points each), and {"logits": (masks,
    coords, g)}, the matched logits' forward (10 * b * 100 128x128 masks,
    12544 points each: 9408 y-stratified importance points in chunk order, top
    to bottom, then 3136 uniform ones) with the gradient its backward got.
    Captured by wrapping the criterion's point_sample_auto."""
    from autofocusformermod_torch.losses import criterion

    calls = []

    def capture(real):
        def wrapped(masks, coords):
            out = real(masks, coords)
            entry = [masks.detach().clone(), coords.detach().clone(), None]
            calls.append(entry)
            if out.requires_grad:
                out.register_hook(lambda g: entry.__setitem__(2, g.detach().clone()))
            return out
        return wrapped

    seeded_step(dev, b, criterion, "point_sample_auto", capture)
    if len(calls) != 2 or calls[0][2] is not None or calls[1][2] is None:
        raise SystemExit(f"the criterion made {len(calls)} point_sample calls; expected the "
                         "targets' (no gradient) and the logits' (with one)")
    (tm, tc, _), (lm, lc, lg) = calls
    return {"targets": (tm, tc), "logits": (lm, lc, lg)}


def path_lapjv_operands(dev, b=TRAIN_BATCH):
    """The cost K13 solves in one batch-b AFF-Mini training step at 512x512
    (seeded weights, label maps and draws): the 10 layers' (b, 100 queries,
    100 target slots) matching costs stacked into one (10 * b, 100, 100), the
    8-12 real targets of each image first and the padded slots at the
    matcher's 1e8.  Captured by wrapping the criterion's solve_lsap."""
    from autofocusformermod_torch.losses import criterion

    costs = []

    def capture(real):
        def wrapped(cost):
            costs.append(cost.detach().float().contiguous().clone())
            return real(cost)
        return wrapped

    seeded_step(dev, b, criterion, "solve_lsap", capture)
    if len(costs) != 1:
        raise SystemExit(f"the criterion made {len(costs)} assignment solves; expected one")
    return costs[0]


def path_knn_operands(dev, b=BATCH):
    """The operands of K9's calls in one seeded batch-b AFF-Mini forward at
    512x512: [(label, query, database, k)] in call order (the four stages'
    cluster neighbours, the two merges' nearest-neighbour distances, the
    pixel decoder's three 4-NN tables and the FPN's Shepard upsampling).
    From stage 2 on the positions are the kept tokens, not a grid.
    Captured by wrapping the kernel call inside geometry.knn.knn."""
    import torch
    from autofocusformermod_torch.config import aff_mini_cfg
    from autofocusformermod_torch.geometry import knn as knn_mod
    from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config

    cfg = aff_mini_cfg()
    model = maskformer_from_config(cfg)
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    images = torch.randint(0, 256, (b, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(
        SEED + 2), dtype=torch.uint8).to(dev)
    calls, real = [], knn_mod._knn_cuda

    def capture(query, database, k):
        calls.append((query.clone(), database.clone(), k))
        return real(query, database, k)

    knn_mod._knn_cuda = capture
    try:
        with torch.no_grad():
            model(images)
    finally:
        knn_mod._knn_cuda = real
    del model, images
    torch.cuda.empty_cache()
    labels = ["cluster_s1", "cluster_s2", "merge_s2", "cluster_s3", "merge_s3", "cluster_s4",
              "table_16", "table_32", "table_64", "fpn_shepard"]
    if len(calls) != len(labels):
        raise SystemExit(f"the forward made {len(calls)} knn calls; expected {len(labels)}")
    return [(label, *call) for label, call in zip(labels, calls)]


def point_sample_uniform_operands(dev, gen):
    """K10's operands at a batch-8 step's shapes with uniform coordinates, in
    the layout of path_point_sample_operands."""
    import torch

    n_t, layers, pts = TRAIN_BATCH * 100, 10, 12544
    tm = (torch.rand((n_t, SIZE, SIZE), generator=gen) < 0.3).float().to(dev)
    tc = torch.rand((n_t, layers * pts, 2), generator=gen).to(dev)
    lm = (torch.randn((layers * n_t, 128, 128), generator=gen) * 3).to(dev)
    lc = torch.rand((layers * n_t, pts, 2), generator=gen).to(dev)
    lg = torch.randn((layers * n_t, pts), generator=gen).to(dev)
    return {"targets": (tm, tc), "logits": (lm, lc, lg)}


def check_point_sample(dev, gen, path_ops):
    """K10 at a batch-8 step's calls: the target labels' forward, the matched
    logits' forward and the logits' backward (point_sample_calls).  Two
    operand sets: uniform coordinates (with the reference sampler's ranking
    read of 8000 masks x 37632 candidates, which the default criterion no
    longer makes: held and timed, not summed), and the path's own
    (`path_ops`, path_point_sample_operands), whose figures are the
    record's."""
    import torch

    paths = {"uniform": point_sample_calls("uniform", point_sample_uniform_operands(dev, gen),
                                           gen, ranking=True)}
    torch.cuda.empty_cache()
    paths["path"] = point_sample_calls("path", path_ops, gen)
    torch.cuda.empty_cache()
    return {"name": "point_sample", "route": "cuda",
            "source": "autofocusformermod_torch/csrc/point_sample.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/point_sample_kernel.py:200",
            "library_ms": paths["path"]["library_ms"], **per_path(paths, "path")}


def point_sample_calls(label, ops, gen, ranking=False):
    """K10 on one step's calls, `ops` {"targets": (masks, coords), "logits":
    (masks, coords, g)}: the target labels' forward, the matched logits'
    forward and the logits' backward; ms sums the three on the routes the
    wrapper picks (masks up to 227 KB take the shared route, the targets'
    512x512 masks the direct one).  Every route that fits a call (shared and
    direct, forward and backward) is held against the plain version and
    timed (`routes`).  ranking: also hold and time (not sum) a ranking read
    of the logits at 3 times their points.  The library call is
    F.grid_sample (and its backward) on the same masks and points."""
    import torch
    import torch.nn.functional as F
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.point_sample import (
        point_sample_backward, point_sample_bilinear, point_sample_forward, point_sample_route)

    def grid_sample(m, grid):
        return F.grid_sample(m[:, None], grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    def routes_of(m):
        return ("shared", "direct") if point_sample_route(*m.shape[1:]) == "shared" else ("direct",)

    fwd_err, ms, plain_ms, lib_ms, bnd, routes = 0.0, 0.0, 0.0, 0.0, {}, {}
    lm, lc, lg = ops["logits"]
    calls = [("targets", *ops["targets"]), ("logits", lm, lc)]
    if ranking:
        calls.insert(0, ("ranking", lm, torch.rand((lm.shape[0], 3 * lc.shape[1], 2),
                                                   generator=gen).to(lm.device)))
    for name, m, coords in calls:
        with plain_versions():
            ref = point_sample_bilinear(m, coords)
            t_p = cuda_ms(lambda: point_sample_bilinear(m, coords), iters=3, warmup=1)
        t_k = cuda_ms(lambda: point_sample_bilinear(m, coords), iters=5, warmup=1)
        for route in routes_of(m):
            e = (point_sample_forward(m, coords, route=route) - ref).abs().max().item()
            fwd_err = max(fwd_err, e)
            routes[f"{name}_fwd_{route}"] = {
                "max_abs_err": e,
                "ms": cuda_ms(lambda: point_sample_forward(m, coords, route=route), iters=5,
                              warmup=1)}
        grid = (coords * 2 - 1)[:, None]
        e_lib = (grid_sample(m, grid)[:, 0, 0] - ref).abs().max().item()
        t_l = cuda_ms(lambda: grid_sample(m, grid), iters=5, warmup=1)
        on_path = name != "ranking"
        if on_path:
            ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
            # per point: the pixel coordinate, four weights and the blend, ~20
            bnd = add_bounds(bnd, bound(nbytes(m, coords, ref), 20 * coords.shape[0]
                                        * coords.shape[1]))
        log(f"  point_sample {label} fwd {name:8s} masks={tuple(m.shape)} points="
            f"{coords.shape[1]}: kernel {t_k:.4f} ms on the {point_sample_route(*m.shape[1:])} "
            f"route; " + ", ".join(f"{r} err {routes[f'{name}_fwd_{r}']['max_abs_err']:.3e} "
                                   f"{routes[f'{name}_fwd_{r}']['ms']:.4f} ms"
                                   for r in routes_of(m))
            + f"; plain {t_p:.4f} ms, grid_sample {t_l:.4f} ms (its err vs plain {e_lib:.3e})"
            + ("" if on_path else " [not on the default path]"))
        del ref, grid
    # the logits' backward
    leaf = lm.clone().requires_grad_()
    with plain_versions():
        want = torch.autograd.grad(point_sample_bilinear(leaf, lc), leaf, lg)[0]
    bwd_err, bwd_rel = 0.0, 0.0
    for route in routes_of(lm):
        got = point_sample_backward(lc, lg, tuple(lm.shape), route=route)
        e, rel = grad_errs([got], [want])
        bwd_err, bwd_rel = max(bwd_err, e), max(bwd_rel, rel)
        routes[f"logits_bwd_{route}"] = {
            "max_abs_err": e, "rel_err": rel,
            "ms": cuda_ms(lambda: point_sample_backward(lc, lg, tuple(lm.shape), route=route),
                          iters=5, warmup=1)}
        del got
    t_k = routes[f"logits_bwd_{point_sample_route(*lm.shape[1:])}"]["ms"]
    t_p = plain_grad_ms(lambda: point_sample_bilinear(leaf, lc), [leaf], lg)
    lib_out = grid_sample(leaf, (lc * 2 - 1)[:, None])
    t_l = cuda_ms(lambda: torch.autograd.grad(lib_out, leaf, lg[:, None, None],
                                              retain_graph=True), iters=5, warmup=1)
    ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
    bnd = add_bounds(bnd, bound(nbytes(lc, lg, lm), 20 * lc.shape[0] * lc.shape[1]))
    log(f"  point_sample {label} bwd logits: " + ", ".join(
        f"{r} err {routes[f'logits_bwd_{r}']['max_abs_err']:.3e} (rel "
        f"{routes[f'logits_bwd_{r}']['rel_err']:.3e}) {routes[f'logits_bwd_{r}']['ms']:.4f} ms"
        for r in routes_of(lm)) + f"; plain {t_p:.4f} ms, grid_sample's backward {t_l:.4f} ms")
    log(f"  point_sample {label}: per step {ms:.3f} ms, grid_sample {lib_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.3f} ms")
    if not (fwd_err <= POINT_SAMPLE_ATOL and bwd_rel <= GRAD_RTOL):
        raise SystemExit(f"point_sample ({label}): forward err {fwd_err} > {POINT_SAMPLE_ATOL} "
                         f"or backward rel err {bwd_rel} > {GRAD_RTOL}")
    return {"max_abs_err": max(fwd_err, bwd_err), "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **bnd, "routes": routes}


def check_lapjv(dev, gen, path_cost):
    """K13 on a step's stacked problems: 10 layers x 8 images, 100 queries x
    100 target slots, 8-12 valid targets per image (the rest at the 1e8
    sentinel), on a uniform draw and on the path's own costs (`path_cost`,
    path_lapjv_operands), each held by lapjv_costs; then NaN and inf costs."""
    import torch

    b = 10 * TRAIN_BATCH
    cost = torch.rand((b, 100, 100), generator=gen) * 10 - 5
    n_valid = torch.randint(8, 13, (b,), generator=gen)
    cost = torch.where(torch.arange(100)[None, None] < n_valid[:, None, None], cost, 1e8)
    paths = {label: lapjv_costs(label, c) for label, c in (("b8_uniform", cost.to(dev)),
                                                           ("b8_path", path_cost))}
    check_lapjv_bad_costs(dev, gen)
    return {"name": "lapjv", "route": "cuda", "source": "autofocusformermod_torch/csrc/lapjv.cu",
            "replaces": "autofocusformermod_tpu/ops/pallas/lapjv_kernel.py:161",
            "library_ms": None, "device_ms": paths["b8_path"]["device_ms"],
            **{k: paths["b8_path"][k] for k in ("steps_max", "steps_mean", "ns_per_step")},
            **per_path(paths, "b8_path")}


def lapjv_costs(label, c):
    """K13 on one stacked cost (problems, Q, T): the assignments of both
    routes must equal the plain version's.  ms and device_ms (the card's
    time alone, queued_ms) are those of the route lapjv_route picks; the
    block route's device time stands beside it.  The plain version counts
    each problem's Dijkstra steps: the longest chain (steps_max) sets the
    kernel's time, hence ns_per_step; real and padded target rows apart."""
    import torch
    from autofocusformermod_torch.losses.lapjv import ROUTES, hungarian_lsap, lapjv, lapjv_route

    t0 = time.time()
    ref, steps = hungarian_lsap(c, return_steps=True)
    torch.cuda.synchronize()
    t_p = (time.time() - t0) * 1e3
    for route in ROUTES:
        if not torch.equal(lapjv(c, route=route), ref):
            raise SystemExit(f"lapjv {label} ({route} route): kernel and plain version disagree")
    route = lapjv_route(*c.shape[1:])
    real = (c < 1e7).any(1)                           # (b, T): the real target slots
    per = steps.sum(1).double()
    rec = {"route": route, "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: lapjv(c), iters=5, warmup=1),
           "device_ms": queued_ms(lambda: lapjv(c), iters=10),
           "block_device_ms": queued_ms(lambda: lapjv(c, route="block"), iters=5),
           "plain_ms": t_p, "steps_max": int(per.max()), "steps_mean": float(per.mean()),
           "real_steps_mean": float((steps * real).sum(1).double().mean()),
           "padded_steps_mean": float((steps * ~real).sum(1).double().mean()),
           # every cost read and reduced at least once (a comparison and a
           # subtraction); the solver's sequential steps, which set its real
           # time, are in neither term
           **bound(nbytes(c, ref), 2 * c.numel())}
    rec["ns_per_step"] = rec["device_ms"] * 1e6 / rec["steps_max"]
    log(f"  lapjv {label} cost={tuple(c.shape)}: identical on {ROUTES}; {route} "
        f"{rec['ms']:.4f} ms, on the card {rec['device_ms']:.4f} ms (block "
        f"{rec['block_device_ms']:.4f}); steps per problem max {rec['steps_max']} mean "
        f"{rec['steps_mean']:.1f} (real rows {rec['real_steps_mean']:.1f}, padded "
        f"{rec['padded_steps_mean']:.1f}), {rec['ns_per_step']:.1f} ns a step; plain "
        f"{t_p:.1f} ms")
    return rec


def check_nearest(dev, gen):
    """K11 and K12 at a batch-8 step's ranking shapes (8000 masks of 128x128,
    37632 candidates each = 294 chunks of 128), and K11 on the direct route
    (2000 masks of 256x256: a COCO LSJ batch-2 step's logits, were they not
    stratified), held by hold_nearest."""
    import torch
    from autofocusformermod_torch.ops.point_sample import (point_sample_nearest,
                                                           point_sample_nearest_rows)

    n, h, w, p = 10 * TRAIN_BATCH * 100, 128, 128, 3 * 12544
    chunks = p // 128
    masks = torch.randn((n, h, w), generator=gen).to(dev) * 3
    coords = torch.rand((n, p, 2), generator=gen).to(dev)
    rec = hold_nearest("phase 7", point_sample_nearest, masks, (coords,))
    del coords
    u = torch.rand((n, chunks, 128), generator=gen).to(dev)
    ys = (torch.arange(chunks, device=dev)[None, :, None] + u) * (1.0 / chunks)
    cy = (ys * h).int().clamp(0, h - 1)
    cx = (torch.rand((n, chunks, 128), generator=gen).to(dev) * w).int().clamp(0, w - 1)
    del u, ys
    records = [rec, hold_nearest("", point_sample_nearest_rows, masks, (cx, cy))]
    del masks, cx, cy
    # made on the card from a generator of their own: `gen` feeds the later
    # phases as it did before this call existed
    own = torch.Generator(device=dev).manual_seed(SEED)
    n = 10 * 2 * 100
    masks = torch.randn((n, 256, 256), generator=own, device=dev) * 3
    coords = torch.rand((n, p, 2), generator=own, device=dev)
    rec["by_path"] = {"b8_128x128": {k: rec[k] for k in (
        "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms",
        "nearest_route")},
                      "direct_256x256": hold_nearest("phase 7 direct", point_sample_nearest, masks,
                                                     (coords,))}
    return records


NEAREST_LINES = {"point_sample_nearest": 266, "point_sample_nearest_rows": 344}
# K11's holds, one JSON line each: route, times on the card, bound
NEAREST_LOG = os.path.join("chiprun_out", "k11_holds.jsonl")


def hold_nearest(label, fn, masks, args):
    """K11 (fn point_sample_nearest, args (coords,)) or K12 (fn
    point_sample_nearest_rows, args (cx, cy)) on one call: the kernels copy
    floats, so they must equal their plain versions exactly.  The library
    call is one flat torch.gather on a precomputed cell index.  For K11 the
    call must take the route point_sample_nearest_route gives (counted in
    launches_by_route); its record also has that route and the card's time
    alone (queued_ms), and is appended to NEAREST_LOG.  -> the kernel's
    record."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.point_sample import point_sample_nearest_route

    n, h, w = masks.shape
    if len(args) == 1:
        cell_index = ((args[0][..., 1] * h).int().clamp(0, h - 1) * w
                      + (args[0][..., 0] * w).int().clamp(0, w - 1)).long()
    else:
        cell_index = (args[1] * w + args[0]).long().reshape(n, -1)
    flat = masks.reshape(n, h * w)
    name = fn.__name__
    k11 = len(args) == 1
    by_route = dict(fn.launches_by_route) if k11 else {}
    out = fn(masks, *args)
    took = ({r: k - by_route[r] for r, k in fn.launches_by_route.items() if k != by_route[r]}
            if k11 else {})
    with plain_versions():
        ref = fn(masks, *args)
        t_p = cuda_ms(lambda: fn(masks, *args), iters=3, warmup=1)
    t_k = cuda_ms(lambda: fn(masks, *args), iters=10, warmup=2)
    lib = torch.gather(flat, 1, cell_index)
    t_l = cuda_ms(lambda: torch.gather(flat, 1, cell_index), iters=10, warmup=2)
    same = torch.equal(out, ref) and torch.equal(lib.reshape(out.shape), ref)
    bnd = bound(nbytes(masks, *args, out), 6 * out.numel())
    rec = {"name": name, "route": "cuda", "source": "autofocusformermod_torch/csrc/point_sample.cu",
           "replaces": f"autofocusformermod_tpu/ops/pallas/point_sample_kernel.py:"
                       f"{NEAREST_LINES[name]}",
           "max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p, "library_ms": t_l, **bnd}
    extra = ""
    if k11:
        route = point_sample_nearest_route(h, w)
        rec.update(nearest_route=route, device_ms=queued_ms(lambda: fn(masks, *args)))
        extra = f", on the card {rec['device_ms']:.4f} ms, route {route}"
        os.makedirs(os.path.dirname(NEAREST_LOG), exist_ok=True)
        with open(NEAREST_LOG, "a") as f:
            f.write(json.dumps({"label": label, "masks": [n, h, w], "candidates": out.shape[1],
                                **{k: v for k, v in rec.items() if k not in (
                                    "name", "route", "source", "replaces")}}) + "\n")
    log(f"  {name}{' ' + label if label else ''} masks={tuple(masks.shape)} candidates="
        f"{cell_index.shape[1]}: identical={same} kernel {t_k:.4f} ms{extra}, plain {t_p:.4f} ms, "
        f"torch.gather {t_l:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    if not same:
        raise SystemExit(f"{name} {label}: kernel, plain version and torch.gather disagree")
    if k11 and took != {route: 1}:
        raise SystemExit(f"{name} {label}: the kernel call launched {took}, expected one launch "
                         f"on the {route} route")
    return rec


@contextlib.contextmanager
def kept_nearest(calls):
    """Within the block every K11 launch's operands are kept in `calls`, as
    (masks, coords) copies; the launches count as they would."""
    from autofocusformermod_torch.ops import point_sample as ops_ps

    real = ops_ps.point_sample_nearest_forward

    def keep(masks, coords, route=None):
        calls.append((masks.clone(), coords.clone()))
        return real(masks, coords, route)

    ops_ps.point_sample_nearest_forward = keep
    try:
        yield calls
    finally:
        ops_ps.point_sample_nearest_forward = real


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
# operands in layout_operands, line of the TPU function in msdetrpc_kernel.py,
# the decoder layout that launches it, and the training steps whose operands
# it is held on: record path -> (preset, image size))
MINI15 = "aff_mini_15"
SAMPLING = {"msdetrpc_levels": ("levels", 1841, "per_level", {"b8_path": ("aff_mini", SIZE)}),
            "msdetrpc_levels_t": ("levels_t", 1912, "fused_prep",
                                  {"b8_path": ("aff_mini", SIZE)}),
            "msdetrpc_bh": ("bh", 2359, "head_natural", {"b8_path": ("aff_mini", SIZE)}),
            # where the decoder's level sizes are not all multiples of 128
            "msdetrpc_interleaved": ("interleaved", 1204, "per_level",
                                     {"b8_path": ("aff_mini", ODD_SIZE),
                                      "b8_path_15": (MINI15, SIZE)})}


def sampling_uniform_calls(gen, dev, key, b):
    """One alternate-layout kernel's operands at a batch-b pass's shapes (bh =
    8 b, 3 levels x 16 pairs, c_ = 32; levels of 256, 1024 and 4096 tokens,
    144, 576 and 2304 for the interleaved kernel at 384x384), drawn
    uniformly: one set per query level that reaches the kernel (all three;
    the 4096-token level alone for the pair-major one), each standing for the
    6 encoder layers' calls.  -> [(ops, val, level sizes, g, times)]."""
    import torch

    bh, c_, heads = b * 8, 32, 8
    sizes = (144, 576, 2304) if key == "interleaved" else (256, 1024, 4096)
    val = torch.randn((bh, sum(sizes), c_), generator=gen).to(dev)
    if key == "bh":
        val = val.reshape(b, heads, -1, c_).transpose(1, 2).contiguous()
    calls = []
    for n in (sizes[-1:] if key == "levels_t" else sizes):
        g = torch.randn((bh, n, c_), generator=gen).to(dev)
        if key == "bh":
            g = g.reshape(b, heads, n, c_).transpose(1, 2).contiguous()
        calls.append((layout_operands(gen, dev, bh, n, sizes)[key], val, sizes, g, 6))
    return calls


def path_layout_operands(dev, name, preset="aff_mini", size=SIZE, b=TRAIN_BATCH):
    """The operands of every call of the alternate-layout sampling kernel
    `name` (a SAMPLING key) in one batch-b training step of `preset` at size
    x size (seeded weights, label maps and draws), as the decoder makes them
    under the kernel's layout flag, with the gradient each call's backward
    got: 18 calls (6 of the pair-major kernel, which takes the 4096-token
    level alone).  -> [(ops, val, level sizes, g, 1)]; the interleaved
    kernel's ops are (nn_idx, nn_weight, attn) and its level the whole table.
    Captured by wrapping the decoder's call of the kernel's wrapper."""
    from autofocusformermod_torch.models import pixel_decoder

    key, _, layout, _ = SAMPLING[name]
    calls = []

    def capture(real):
        def wrapped(*args):
            out = real(*args)
            if key == "interleaved":
                *ops, val = args
                entry = [tuple(t.detach().clone() for t in ops), val.detach().clone(),
                         (val.shape[1],), None, 1]
            else:
                idxs, ws, val, level_sizes = args
                entry = [([i.detach().clone() for i in idxs], [w.detach().clone() for w in ws]),
                         val.detach().clone(), tuple(level_sizes), None, 1]
            calls.append(entry)
            out.register_hook(lambda g: entry.__setitem__(3, g.detach().contiguous().clone()))
            return out
        return wrapped

    with decoder_layout(layout):
        seeded_step(dev, b, pixel_decoder, "msdetrpc" if key == "interleaved" else name, capture,
                    preset, size)
    if len(calls) != (6 if layout == "fused_prep" else 18) or any(c[3] is None for c in calls):
        raise SystemExit(f"{name} ({preset}, {size}x{size}): the step made {len(calls)} calls, "
                         f"{sum(c[3] is None for c in calls)} of them without a gradient")
    return [tuple(c) for c in calls]


def stacked_form(key, ops, val, sizes):
    """An alternate-layout kernel's operands relaid to the stacked layout's
    (idx_s, w_s, val, level sizes), as msdetrpc_levels_s_library takes them:
    the head-natural layout's heads moved into the image axis, the
    interleaved kernel's global indices as one level with its attention
    folded into the weights."""
    import torch

    if key == "interleaved":
        idx, w, attn = ops
        bh, n = idx.shape[:2]
        return idx.reshape(bh, n, -1), (w * attn[..., None]).reshape(bh, n, -1), val, (val.shape[1],)
    idxs, ws = ops
    if key == "levels_t":
        idxs, ws = [i.transpose(1, 2) for i in idxs], [w.transpose(1, 2) for w in ws]
    idx_s, w_s = torch.cat(idxs, -1), torch.cat(ws, -1)
    if key == "bh":
        idx_s, w_s, val = (unit_rows(key, t) for t in (idx_s, w_s, val))
    return idx_s.contiguous(), w_s.contiguous(), val.contiguous(), sizes


def unit_rows(key, x):
    """The head-natural layout's (b, n, h, X) as (b * h, n, X); other
    layouts' arrays as they are."""
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[-1]) if key == "bh" else x


def check_sampling(name, key, calls, l2_rate, backward=True, time_plain=True):
    """One alternate-layout kernel on `calls` [(ops, val, level sizes, g,
    times)]; ms figures sum the calls, each `times` times.  The forward
    against its plain version within MSDETRPC_ATOL, timed in calls (cuda_ms)
    and on the card alone (device_ms, queued_ms), beside the plain version
    (with time_plain) and the library call: F.embedding_bag on the operands
    relaid to the stacked form (msdetrpc_levels_s_library), the relayout and
    the bag's rows timed apart (library_rows_ms); l2_rows_ms is the least
    time in which the card's L2 serves every query's value rows.  With
    `backward` the same for the backward kernels (bwd_*: the gradients
    against the plain version's autograd within GRAD_RTOL, beside
    embedding_bag's autograd backward), and two calls compared bit for bit
    (every kernel sums in a fixed order)."""
    import torch
    from autofocusformermod_torch.ops import clusten, msdetrpc as md
    from autofocusformermod_torch.ops.dispatch import plain_versions

    t = dict.fromkeys(("ms", "device_ms", "plain_ms", "library_ms", "library_rows_ms", "bwd_ms",
                       "bwd_device_ms", "bwd_plain_ms", "bwd_library_ms"), 0.0)
    err, lib_err, bwd_err, worst, row_bytes, bnd, bwd_bnd = 0.0, 0.0, 0.0, 0.0, 0, {}, {}
    for ops, val, sizes, g, times in calls:
        if key == "interleaved":
            idx, w, attn = ops
            diff = [w, attn, val]

            def fwd(leaves=diff):
                return clusten.msdetrpc(idx, *leaves)

            def bwd():
                return list(clusten.msdetrpc_backward(idx, w, attn, val, g))
        else:
            fn = getattr(md, name)
            idxs, ws = ops
            diff = [val, *ws]

            def fwd(leaves=diff):
                return fn(idxs, leaves[1:], leaves[0], sizes)

            def bwd():
                d_val, d_ws = fn.backward_launcher(idxs, ws, val, g, sizes)
                return [d_val, *d_ws]
        out = fwd()
        with plain_versions():
            ref = fwd()
            t_p = cuda_ms(fwd, iters=5, warmup=1) if time_plain else 0.0
        e = (out - ref).abs().max().item()
        err = max(err, e)
        rows, c_ = out.numel() // out.shape[-1], out.shape[-1]
        lp = ops[0].numel() // rows if key == "interleaved" else sum(i.numel() for i in ops[0]) // rows

        def library_operands():
            idx_s, w_s, val_s, sizes_s = stacked_form(key, ops, val, sizes)
            return md.msdetrpc_bag_rows(idx_s, sizes_s), idx_s, w_s, val_s, sizes_s

        bag, idx_s, w_s, val_s, sizes_s = library_operands()
        lib = md.msdetrpc_levels_s_library(idx_s, w_s, val_s, sizes_s, rows=bag)
        lib_err = max(lib_err, (lib - unit_rows(key, ref)).abs().max().item())
        step = {"ms": cuda_ms(fwd), "device_ms": queued_ms(fwd), "plain_ms": t_p,
                "library_ms": cuda_ms(lambda: md.msdetrpc_levels_s_library(
                    idx_s, w_s, val_s, sizes_s, rows=bag)),
                "library_rows_ms": cuda_ms(library_operands, iters=5, warmup=1)}
        moved = nbytes(*(ops[0] if key != "interleaved" else ops[:1]), *diff)
        # a multiply and an add per (query, pair, channel)
        bnd = add_bounds(bnd, bound(moved + nbytes(out), 2 * rows * lp * c_), times)
        row_bytes += times * rows * lp * c_ * 4
        msg = (f"  {name} {len(calls)} calls{'' if times == 1 else f' x {times}'} n={out.shape[1]} "
               f"levels={sizes}: fwd max_abs_err {e:.3e} kernel {step['ms']:.4f} ms (on the card "
               f"{step['device_ms']:.4f}), plain {t_p:.4f}, embedding_bag {step['library_ms']:.4f} "
               f"(+ relayout and rows {step['library_rows_ms']:.4f})")
        if backward:
            leaves = [x.clone().requires_grad_() for x in diff]
            got = torch.autograd.grad(fwd(leaves), leaves, g)
            with plain_versions():
                want = torch.autograd.grad(fwd(leaves), leaves, g)
            be, rel = grad_errs(got, want)
            bwd_err, worst = max(bwd_err, be), max(worst, rel)
            if not all(torch.equal(a, b) for a, b in zip(bwd(), bwd())):
                raise SystemExit(f"{name} backward ({len(calls)} calls, n={out.shape[1]}): two "
                                 "calls on the same inputs differ")
            lib_leaves = [w_s.clone().requires_grad_(), val_s.clone().requires_grad_()]
            lib_out = md.msdetrpc_levels_s_library(idx_s, *lib_leaves, sizes_s, rows=bag)
            g_s = unit_rows(key, g).contiguous()
            step.update({"bwd_ms": cuda_ms(bwd), "bwd_device_ms": queued_ms(bwd),
                         "bwd_plain_ms": (plain_grad_ms(lambda: fwd(leaves), leaves, g)
                                          if time_plain else 0.0),
                         "bwd_library_ms": cuda_ms(lambda: torch.autograd.grad(
                             lib_out, lib_leaves, g_s, retain_graph=True))})
            # d_val += w g and d_w = g . val: 4 operations per (query, pair, channel)
            bwd_bnd = add_bounds(bwd_bnd, bound(moved + nbytes(g, *diff), 4 * rows * lp * c_),
                                 times)
            msg += (f"; bwd max_abs_err {be:.3e} (rel {rel:.3e})"
                    f", bit-identical twice, kernels "
                    f"{step['bwd_ms']:.4f} ms (on the card {step['bwd_device_ms']:.4f}), plain "
                    f"{step['bwd_plain_ms']:.4f}, embedding_bag's backward "
                    f"{step['bwd_library_ms']:.4f}")
            del leaves, got, want, lib_leaves, lib_out
        for k, v in step.items():
            t[k] += times * v
        log(msg)
        del out, ref, bag, idx_s, w_s, val_s, lib
    if err > MSDETRPC_ATOL or lib_err > MSDETRPC_ATOL or worst > GRAD_RTOL:
        raise SystemExit(f"{name}: kernel, plain version and embedding_bag disagree (forward abs "
                         f"{err}, library abs {lib_err}, backward rel {worst})")
    rec = {"max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"] if time_plain else None,
           **bnd, "device_ms": t["device_ms"], "library_ms": t["library_ms"],
           "library_rows_ms": t["library_rows_ms"], "row_bytes": row_bytes,
           "l2_rows_ms": row_bytes / l2_rate * 1e3}
    if backward:
        rec.update({"bwd_max_abs_err": bwd_err, "bwd_max_rel_err": worst, "bwd_ms": t["bwd_ms"],
                    "bwd_device_ms": t["bwd_device_ms"],
                    "bwd_plain_ms": t["bwd_plain_ms"] if time_plain else None,
                    "bwd_library_ms": t["bwd_library_ms"], "bwd_bound_ms": bwd_bnd["bound_ms"],
                    "bwd_bound_by": bwd_bnd["bound_by"], "bit_identical": True})
    log(f"  {name}: {t['ms']:.3f} ms in calls, {t['device_ms']:.3f} on the card; embedding_bag "
        f"{t['library_ms']:.3f} (+ {t['library_rows_ms']:.3f}); bound {bnd['bound_ms']:.3f} ms; "
        f"value rows at the L2 rate {rec['l2_rows_ms']:.3f} ms"
        + (f"; backward {t['bwd_ms']:.3f} ms in calls, {t['bwd_device_ms']:.3f} on the card, "
           f"embedding_bag's {t['bwd_library_ms']:.3f}, bound {bwd_bnd['bound_ms']:.3f}"
           if backward else ""))
    return rec


def sampling_record(name, gen, dev, l2_rate):
    """The record of one alternate-layout kernel: the forward at a batch-4
    forward's shapes (the record's own figures, as in earlier records), both
    passes at a batch-8 step's, on the uniform draw and on the operands of
    real steps under its layout's flag (SAMPLING)."""
    import torch

    key, line, _, steps = SAMPLING[name]
    paths = {f"b{BATCH}_forward": check_sampling(
        name, key, sampling_uniform_calls(gen, dev, key, BATCH), l2_rate, backward=False)}
    paths[f"b{TRAIN_BATCH}_step"] = check_sampling(
        name, key, sampling_uniform_calls(gen, dev, key, TRAIN_BATCH), l2_rate)
    torch.cuda.empty_cache()
    for path, (preset, size) in steps.items():
        log(f"  {name} on the operands of a batch-{TRAIN_BATCH} {preset} step at {size}x{size}")
        paths[path] = check_sampling(name, key, path_layout_operands(dev, name, preset, size),
                                     l2_rate, time_plain=False)
        paths[path]["preset"], paths[path]["size"] = preset, size
        torch.cuda.empty_cache()
    own = paths[f"b{BATCH}_forward"]
    return {"name": name, "route": "cuda", "source": "autofocusformermod_torch/csrc/msdetrpc.cu",
            "replaces": f"autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:{line}", **own,
            "max_abs_err": max(max(p["max_abs_err"], p.get("bwd_max_abs_err", 0.0))
                               for p in paths.values()),
            "deterministic": True, "by_path": paths}


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
    """The matcher's kernel on NaN and +-inf costs, on both routes: it must
    end (a NaN counts as the largest cost) and agree with the plain version.
    A loop that never ends would hang the process, so each launch is
    watched from the host: the stream is polled against a time limit of its
    own."""
    import torch
    from autofocusformermod_torch.losses.lapjv import ROUTES, hungarian_lsap, lapjv

    cost = torch.rand((6, 100, 100), generator=gen) * 10 - 5
    cost[0] = float("nan")
    cost[1, 10:20] = float("nan")
    cost[2, :, 30:60] = float("nan")
    cost[3, 5, 5], cost[3, 6, 7] = float("inf"), float("-inf")
    cost[4] = float("inf")
    cost[5, ::2, ::3] = float("nan")
    cost[:, :, 90:] = 1e8
    cost = cost.to(dev)
    ref = hungarian_lsap(cost)
    # the same problems with the bad values written out: what the 90 real
    # targets of each cost, NaN or not (a step's problems have 8-12)
    clean = torch.nan_to_num(cost, nan=3e4).clamp(-3e4, 3e4)
    for route in ROUTES:
        done = torch.cuda.Event()
        torch.cuda.synchronize()
        t0 = time.time()
        got = lapjv(cost, route=route)
        done.record()
        while not done.query():
            if time.time() - t0 > limit_s:
                log(f"  lapjv ({route} route) on NaN / inf costs: still running after {limit_s} s")
                sys.stdout.flush()
                import os
                os._exit(1)       # the kernel cannot be stopped; leave without waiting for it
            time.sleep(0.01)
        took = time.time() - t0
        same = torch.equal(got, ref)
        distinct = all(len(set(row)) == 100 for row in got.tolist())
        t_clean = cuda_ms(lambda: lapjv(clean, route=route), iters=1, warmup=0)
        log(f"  lapjv ({route} route) on NaN / inf costs {tuple(cost.shape)}, 90 real targets "
            f"each: ended in {took:.3f} s (the same costs cleaned beforehand: {t_clean:.1f} ms), "
            f"identical to the plain version={same}, distinct queries={distinct}")
        if not (same and distinct):
            raise SystemExit(f"lapjv ({route} route) on NaN / inf costs: kernel and plain "
                             "version disagree")


def device_busy(fn, runs=3):
    """(device busy ms, device rows) per call of fn: the durations of the
    kernel, memcpy and memset rows the profiler records on the card, ranges
    left out.  Summed from the profiler's raw events: building its event
    tree (key_averages) took 5-9 s a call on the host, and the host's
    operator rows are not needed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    busy, rows = device_rows(prof, "device_busy")
    return busy / runs, rows / runs


def device_rows(prof, label):
    """(busy ms, rows) of a finished profiler session: its kernel, memcpy
    and memset rows on the card, ranges left out."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", lambda: False)()]
    if not rows:
        raise SystemExit(f"{label}: the profiler recorded no row on the card")
    return sum(e.duration_ns() for e in rows) / 1e6, len(rows)


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
    """Phase 9's end-to-end part.  Returns ({counter name: launches on the
    layouts' forwards and steps}, {"point_sample_nearest": {path: record}}:
    K11 held on the operands of the 384x384 step's ranking)."""
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
    # the point ranking's read: 512x512 crops give 128-wide masks, which take
    # the stratified route (K12); 384x384 ones give 96-wide masks, no multiple
    # of 128, which take the i.i.d. route (K11), as on the JAX accelerator
    ranking = ("point_sample_nearest", "point_sample_nearest_rows")
    ranking_route = {SIZE: {"point_sample_nearest_rows": 1}, ODD_SIZE: {"point_sample_nearest": 1}}

    def step(batch, choices=contextlib.nullcontext()):
        model.load_state_dict(initial)
        torch.cuda.synchronize()
        t0 = time.time()
        with choices:
            (total_loss, losses, _), got = counted(lambda: TrainStep(model, cfg).loss_and_grads(
                batch, device_draw(torch.Generator(device=dev).manual_seed(SEED))))
        dt = (time.time() - t0) * 1e3
        terms = {"total_loss": total_loss.item(), **{k: v.item() for k, v in losses.items()}}
        reads = {k: v for k, v in got.items() if k in ranking}
        if reads != ranking_route[batch["image"].shape[1]]:
            raise SystemExit(f"step at {batch['image'].shape[1]}: the ranking read through "
                             f"{reads}, expected {ranking_route[batch['image'].shape[1]]}")
        return terms, group_norms(model), {k: v for k, v in got.items() if k in sampling_bwd}, dt

    def worst_rel(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in b)

    paths = {}
    for size, batch_size, names in ((SIZE, TRAIN_BATCH, tuple(LAYOUTS)),
                                    (ODD_SIZE, ODD_TRAIN_BATCH, ("interleaved",))):
        batch = synthetic_batch(torch.Generator().manual_seed(SEED + 1), dev, batch_size,
                                (size, size), cfg.TPU.MAX_GT_INSTANCES,
                                cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
        nearest = []
        with kept_nearest(nearest) if size == ODD_SIZE else contextlib.nullcontext():
            step(batch)                              # warm-up, not compared
        if nearest:
            (masks, coords), = nearest
            paths["point_sample_nearest"] = {f"b{batch_size}_{size}_step": hold_nearest(
                f"phase 9 {size}x{size} step", counters["point_sample_nearest"], masks,
                (coords,))}
            del nearest, masks, coords
        # each layout's step replays the default layout's discrete choices
        book = {}
        ref_terms, ref_norms, ref_got, ref_dt = step(batch, same_choices(book, record=True))
        log(f"  step {size}x{size} batch {batch_size}, default layout: total loss "
            f"{ref_terms['total_loss']:.6f}, {ref_dt:.1f} ms forward + criterion + backward, "
            f"launches {ref_got}")
        for name in names:
            # the channel-major prep snaps its cells in its own arithmetic, the
            # head-natural one in another order: they make their own
            skip = ("sampling cells",) if name in ("fused_prep", "head_natural") else ()
            with decoder_layout("per_level" if name == "interleaved" else name):
                terms, norms, got, dt = step(batch, same_choices(book, False, skip))
            rel, norm_rel = worst_rel(terms, ref_terms), worst_rel(norms, ref_norms)
            log(f"  step {size}x{size} batch {batch_size}, layout {name}: total loss "
                f"{terms['total_loss']:.6f}, {len(terms) - 1} loss terms worst rel diff {rel:.3e}, "
                f"grad norms per group worst rel diff {norm_rel:.3e}, {dt:.1f} ms, launches {got} "
                f"({smi})")
            same_choices.check(f"step {size}x{size} batch {batch_size}, layout {name}", book)
            if got != bwd[name]:
                raise SystemExit(f"step under layout {name}: launched {got}, expected {bwd[name]}")
            if not all(v == v and abs(v) != float("inf") for v in terms.values()):
                raise SystemExit(f"step under layout {name}: non-finite loss terms")
            if rel > LOSS_RTOL or norm_rel > GROUP_NORM_RTOL:
                raise SystemExit(f"step under layout {name}: loss terms differ by {rel}, gradient "
                                 f"norms by {norm_rel} (rel) from the default layout's")
        del batch
        torch.cuda.empty_cache()
    return total, paths


# AFF-Mini-1/5's decoder levels at 512x512: its cluster merging keeps
# int(n * 0.2) tokens a stage, no multiples of 128
MINI15_LEVELS = (3276, 655, 131)


class same_choices:
    """Within the block the run's discrete choices are recorded into `book`
    (record=True), or the recorded ones are returned in their order
    (record=False) -- the backbone's kept tokens (models/aff.py
    topk_indices), the finest-grid cells the pixel decoder's sampling
    locations snap to (models/pixel_decoder.py grid_cells: rounded), the
    masked decoders' attention masks (sigmoid < 0.5:
    MultiScaleMaskedTransformerDecoder._prediction_heads, models/maskfiner.py
    attention_mask), the point ranking's points (losses/point_sample.py
    topk_indices), the criterion's matches (criterion.solve_lsap), the
    MaskFiner cascade's split order (models/mixres.py split_order), the
    classes its queries vote for in the disagreement (models/maskfiner.py
    predicted_classes) and the MRML backbone's split and kept tokens
    (models/mrml.py topk_indices, in their order).  When replaying, each choice is also made, and
    book["agree"][kind] counts its elements equal to the recorded ones
    (kept tokens and ranked points as sets per row) against all of them.  At
    random initialisation near-tied scores flip between two fp32 orders of
    summation and a flip changes the run downstream; with the choices held,
    a kernel run and a plain run compute the same function of the same
    inputs, and the counts say how many choices flipped.  With `near_ties`
    the recording also keeps the scores the matches and the ranked points
    were chosen by, and each replay measures its flips against them
    (near_tie).  One recording can be replayed several times (each replay
    counts into its own copy of "agree" and "near ties")."""

    KINDS = (("kept tokens", "autofocusformermod_torch.models.aff", None, "topk_indices"),
             ("sampling cells", "autofocusformermod_torch.models.pixel_decoder", None,
              "grid_cells"),
             ("attention masks", "autofocusformermod_torch.models.transformer_decoder",
              "MultiScaleMaskedTransformerDecoder", "_prediction_heads"),
             ("attention masks", "autofocusformermod_torch.models.maskfiner", None,
              "attention_mask"),
             ("ranked points", "autofocusformermod_torch.losses.point_sample", None,
              "topk_indices"),
             ("matches", "autofocusformermod_torch.losses.criterion", None, "solve_lsap"),
             ("split tokens", "autofocusformermod_torch.models.mixres", None, "split_order"),
             ("class votes", "autofocusformermod_torch.models.maskfiner", None,
              "predicted_classes"),
             ("meta-loss split", "autofocusformermod_torch.models.mrml", None, "topk_indices"))
    SETS = ("kept tokens", "ranked points")
    SCORED = ("ranked points", "matches", "class votes")

    def __init__(self, book, record, skip=(), near_ties=False):
        """skip: kinds left to the run (a layout that snaps its sampling
        cells in another arithmetic or order than the recorded run);
        near_ties: record the SCORED kinds' scores too."""
        self.book, self.record, self.skip, self.near_ties = book, record, skip, near_ties

    def __enter__(self):
        import importlib

        if not self.record:
            self.book["agree"] = {}
            self.book["near ties"] = {}
        self.saved = []
        for kind, module, cls, name in self.KINDS:
            if kind in self.skip:
                continue
            owner = importlib.import_module(module)
            owner = getattr(owner, cls) if cls else owner
            real = getattr(owner, name)
            self.saved.append((owner, name, real))
            setattr(owner, name, self.wrap(kind, (module, cls, name), real,
                                           part=2 if cls else None))
        return self

    def wrap(self, kind, where, real, part):
        """part: the index of the choice in a tuple result (the attention
        mask of the decoder's prediction heads), else the whole result."""
        calls = self.book.setdefault(where, [])
        scores = self.book.setdefault(("scores", *where), [])
        at = iter(range(len(calls)))
        agree = self.book.setdefault("agree", {}).setdefault(kind, [0, 0])
        if kind == "matches":
            valid_agree = self.book["agree"].setdefault("valid matches", [0, 0])

        def wrapped(*args, **kwargs):
            out = real(*args, **kwargs)
            own = out if part is None else out[part]
            if self.record:
                calls.append(own)
                if self.near_ties and kind in self.SCORED:
                    scores.append(args[0].detach().float().clone())
                return out
            i = next(at)
            want = calls[i]
            agree[0] += self.equal_elements(kind, own, want)
            agree[1] += want.numel()
            if kind == "matches":
                valid = self.valid_slots(args[0])
                valid_agree[0] += int(((own == want) & valid).sum())
                valid_agree[1] += int(valid.sum())
            if i < len(scores):
                self.near_tie(kind, args[0].detach().float(), scores[i], own, want)
            return want if part is None else (*out[:part], want, *out[part + 1:])
        return wrapped

    @staticmethod
    def valid_slots(cost):
        """(problems, slots) bool: the target slots that hold a target (a
        padded slot costs _INVALID_COST for every query)."""
        from autofocusformermod_torch.losses.matcher import _INVALID_COST

        return cost[:, 0, :] < _INVALID_COST

    def near_tie(self, kind, mine, theirs, own, want):
        """How much more the recorded choice `want` costs than the plain
        run's own under the plain run's scores `mine`, beside what the two
        runs' scores of the choices involved (`theirs`: the kernel run's)
        differ by.  A choice one run's scores make, the other's cost at most
        that much more: for an assignment (solve_lsap's cost (problems,
        queries, slots), valid target slots summed per problem; the
        solver's fp32 arithmetic adds NEAR_TIE_ROUNDING of the sum), each
        matched pair's difference; for a ranking (topk_indices'
        uncertainties per row; predicted_classes' class scores, one pick a
        row), the largest difference among the recorded and among the own
        picks, since the k-th largest entry moves no more than the entries
        do.  Keeps the worst (gap - bound, gap, bound) of
        the kind in book["near ties"][kind]."""
        import torch

        diff = (mine - theirs).abs()
        if kind == "matches":
            valid = self.valid_slots(mine)                            # (problems, slots)

            def summed(c, picks):
                return (torch.gather(c, 1, picks.long()[:, None, :])[:, 0].double()
                        * valid).sum(1)

            gap = summed(mine, want) - summed(mine, own)
            bound = (summed(diff, want) + summed(diff, own)
                     + NEAR_TIE_ROUNDING * summed(mine.abs(), own))
        else:
            if own.dim() < mine.dim():            # an argmax: one pick a row
                own, want = own[..., None], want[..., None]

            def least(c, picks):
                return torch.gather(c, -1, picks.long()).amin(-1)

            def most(c, picks):
                return torch.gather(c, -1, picks.long()).amax(-1)

            gap = least(mine, own) - least(mine, want)
            bound = most(diff, want) + most(diff, own)
        gap, bound = gap.reshape(-1).double(), bound.reshape(-1).double()
        j = int((gap - bound).argmax())
        worst = self.book["near ties"].setdefault(kind, [-math.inf, 0.0, 0.0])
        if float(gap[j] - bound[j]) > worst[0]:
            worst[:] = [float(gap[j] - bound[j]), float(gap[j]), float(bound[j])]

    def __exit__(self, *exc):
        for owner, name, real in self.saved:
            setattr(owner, name, real)

    @classmethod
    def equal_elements(cls, kind, own, want) -> int:
        import torch

        if own.shape != want.shape:
            return 0
        if kind not in cls.SETS:
            return int((own == want).sum())
        rows = want.reshape(-1, want.shape[-1]).sort(-1).values
        mine = own.reshape(-1, own.shape[-1]).contiguous()
        at = torch.searchsorted(rows, mine).clamp(max=rows.shape[-1] - 1)
        return int((rows.gather(-1, at) == mine).sum())

    @staticmethod
    def check(label, book, by_scores=(), floors=None, near_tie_floors=None):
        """Log each choice's agreement; fail where it is below its floor
        (`floors`, CHOICE_AGREE_MIN by default; a kind the floors do not
        name, "valid matches" but in phase 19, is logged only).
        by_scores: kinds whose scores the caller holds to the bound their
        inputs' differences set (check_disagreement for the split order),
        which bounds where the order can differ; logged, not held here."""
        shares = {kind: e / n for kind, (e, n) in book.get("agree", {}).items() if n}
        ties = book.get("near ties", {})
        log(f"    {label}: the plain run's own choices equal the kernel run's in "
            + "; ".join(f"{kind} {book['agree'][kind][0]}/{book['agree'][kind][1]} "
                        f"({shares[kind]:.6f}{', held by its scores' if kind in by_scores else ''})"
                        for kind in shares)
            + "".join(f"; {kind}: the recorded choice's extra cost under the plain run's "
                      f"scores less what the runs' scores of it differ by, at worst {excess:.3e} "
                      f"({gap:.3e} - {bound:.3e})" for kind, (excess, gap, bound) in ties.items()))
        # under its floor, a kind measured against its scores (near_ties)
        # passes above NEAR_TIE_AGREE_MIN (or `near_tie_floors`) where every
        # flip is one those scores explain
        floors = CHOICE_AGREE_MIN if floors is None else floors
        near_tie_floors = NEAR_TIE_AGREE_MIN if near_tie_floors is None else near_tie_floors
        explained = tuple(kind for kind, (excess, _, _) in ties.items()
                          if excess <= 0 and shares.get(kind, 1.0) >= near_tie_floors[kind])
        low = {kind: v for kind, v in shares.items()
               if v < floors.get(kind, 0.0) and kind not in by_scores + explained}
        if low:
            raise SystemExit(f"{label}: the plain run's choices part from the kernel run's in "
                             f"{low} of their elements (floors {floors})")


def check_forward(label, out, ref, book, b=BATCH, size=SIZE):
    """A batch-`b` forward's outputs through the kernels against the plain
    run's, which replayed the kernel run's choices (`book`)."""
    import torch

    for key, shape in (("pred_logits", (b, 100, 151)),
                       ("pred_masks", (b, 100, size // 4, size // 4))):
        a, r = out[key], ref[key]
        if tuple(a.shape) != shape or not torch.isfinite(a).all():
            raise SystemExit(f"{label} {key}: shape {tuple(a.shape)} (expected {shape}) or "
                             "non-finite")
        e = (a - r).abs().max().item()
        scale = r.abs().max().item()
        log(f"    {key}: max_abs_err vs plain {e:.3e} (max |ref| {scale:.3e}, rel "
            f"{e / max(scale, 1.0):.3e})")
        if e > FORWARD_RTOL * max(scale, 1.0):
            raise SystemExit(f"{label} {key}: kernels and plain versions disagree by {e}")
    same_choices.check(label, book)


def mini15_phase(dev, smi, counters):
    """Phase 10: the published AFF-Mini-1/5 preset at 512x512 (seeded random
    weights), in the default layout and with USE_STACKED_GLUE off (the
    interleaved kernel): one batch-4 forward and one batch-8 training step
    each through the kernels, with every kernel's launches, then through the
    plain versions from the same weights, images, batch and generators,
    replaying the kernel run's discrete choices (same_choices); device busy
    of each layout's forward.  Returns {counter name: launches}."""
    import contextlib

    import torch
    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.data.synthetic import synthetic_batch
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config
    from autofocusformermod_torch.ops.dispatch import plain_versions

    cfg = PRESETS[MINI15]()
    model = maskformer_from_config(cfg)
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(SEED + 2)).to(dev)
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

    with torch.no_grad():
        feats = model.backbone(model.normalize(images))
    sizes = tuple(feats[f"res{i}"].shape[1] for i in (3, 4, 5))
    log(f"  decoder levels {sizes}")
    if sizes != MINI15_LEVELS:
        raise SystemExit(f"{MINI15}: decoder levels {sizes}, expected {MINI15_LEVELS}")
    del feats
    layouts = {None: "msdetrpc", "per_level": "msdetrpc_interleaved"}
    for layout, op in layouts.items():
        book = {}
        with decoder_layout(layout), torch.no_grad():
            t0 = time.time()
            with same_choices(book, record=True):
                out, got = counted(lambda: model(images))
            dt = (time.time() - t0) * 1e3
            with same_choices(book, record=False), plain_versions():
                ref = model(images)
            busy, rows = device_busy(lambda: model(images))
        want = {"local_attn": 12, "knn": 10, op: 18}
        log(f"  batch-{BATCH} forward, layout {layout or 'default'}: {dt:.1f} ms (first call), "
            f"device busy {busy:.2f} ms in {rows:.0f} rows ({smi}), launches {got}")
        if got != want:
            raise SystemExit(f"{MINI15} forward, layout {layout}: launched {got}, expected {want}")
        check_forward(f"{MINI15} forward, layout {layout or 'default'}", out, ref, book)
        del out, ref
    del images

    model.train()
    batch = synthetic_batch(torch.Generator().manual_seed(SEED + 1), dev, TRAIN_BATCH,
                            (SIZE, SIZE), cfg.TPU.MAX_GT_INSTANCES,
                            cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)

    def step(path=contextlib.nullcontext):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.time()
        with path():
            (total_loss, losses, _), got = counted(lambda: TrainStep(model, cfg).loss_and_grads(
                batch, device_draw(torch.Generator(device=dev).manual_seed(SEED))))
        dt = (time.time() - t0) * 1e3
        terms = {"total_loss": total_loss.item(), **{k: v.item() for k, v in losses.items()}}
        return terms, group_norms(model), got, dt

    def worst_rel(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in b)

    per_step = {"local_attn": 12, "local_attn_bwd": 12, "point_sample": 2, "point_sample_bwd": 1,
                "lapjv": 1, "knn": 10, "point_sample_nearest_rows": 1}
    for layout, op in layouts.items():
        book = {}
        with decoder_layout(layout):
            with same_choices(book, record=True):
                terms, norms, got, dt = step()
            with same_choices(book, record=False):
                ref_terms, ref_norms, _, ref_dt = step(plain_versions)
        want = {**per_step, op: 18, op + "_bwd": 18}
        rel, norm_rel = worst_rel(terms, ref_terms), worst_rel(norms, ref_norms)
        log(f"  batch-{TRAIN_BATCH} step, layout {layout or 'default'}: total loss "
            f"{terms['total_loss']:.6f} (plain {ref_terms['total_loss']:.6f}), {len(terms) - 1} "
            f"loss terms worst rel diff {rel:.3e}, grad norms per group worst rel diff "
            f"{norm_rel:.3e}; {dt:.1f} ms (first call; plain {ref_dt:.1f}); launches {got} "
            f"({smi})")
        same_choices.check(f"{MINI15} step, layout {layout or 'default'}", book)
        if got != want:
            raise SystemExit(f"{MINI15} step, layout {layout}: launched {got}, expected {want}")
        if not all(v == v and abs(v) != float("inf") for v in terms.values()):
            raise SystemExit(f"{MINI15} step, layout {layout}: non-finite loss terms")
        if rel > LOSS_RTOL or norm_rel > GROUP_NORM_RTOL:
            raise SystemExit(f"{MINI15} step, layout {layout}: loss terms differ by {rel}, "
                             f"gradient norms by {norm_rel} (rel) from the plain versions'")
    del model, batch
    torch.cuda.empty_cache()
    return total


def group_norms(model):
    """Gradient norm of each optimizer parameter group."""
    import torch
    from autofocusformermod_torch.engine.optimizer import param_groups

    return {label: torch.sqrt(sum((p.grad ** 2).sum() for _, p in named)).item()
            for label, named in param_groups(model).items()}


def replay_step(label, model, cfg, batch, draw, near_ties=False, loss_rtol=LOSS_RTOL,
                group_rtol=GROUP_NORM_RTOL, floors=None, near_tie_floors=None,
                disagreement=False):
    """One training step's forward, criterion and backward from the model's
    weights through the kernels, then through the plain versions from the
    same weights, batch and draws (`draw()` makes the criterion's generator
    afresh), replaying the kernel run's discrete choices.  Holds the loss
    terms to `loss_rtol`, the gradient norm of each optimizer group to
    `group_rtol`, and that every parameter the plain step gives a
    gradient gets one through the kernels.  Where the plain run does not
    fit the card, both runs are made again on the first half of the batch,
    and the log says so.  The generators of DropPath and Dropout and an
    OracleTeacher model's teacher generator start each run from the same
    state, so both drop the same branches and elements and take the same
    teacher draws.  The weights and those
    generators are restored and the gradients cleared after.  near_ties:
    the matches and ranked points may pass under their floors as
    same_choices.check allows (`floors`, `near_tie_floors`: its floors).
    disagreement: a MaskFiner cascade's split order is held, as phase 13
    holds it, through each stage's disagreement (check_disagreement on both
    runs' gini_disagreement inputs), not by its positional agreement.  ->
    (batch used, kernels' ms, plain ms, kernels' peak GiB, plain peak GiB),
    each the first call of its path."""
    import contextlib
    import copy

    import torch
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.models.layers import Stochastic
    from autofocusformermod_torch.ops.dispatch import plain_versions

    initial = copy.deepcopy(model.state_dict())
    gens = {id(m.generator): m.generator for m in model.modules()
            if isinstance(m, Stochastic) and m.generator is not None}
    # an OracleTeacher model's teacher draws
    for owner in (model, getattr(model, "backbone", None)):
        if getattr(owner, "oracle_generator", None) is not None:
            gens[id(owner.oracle_generator)] = owner.oracle_generator
    gen_states = {k: g.get_state() for k, g in gens.items()}

    def restore():
        model.load_state_dict(initial)
        for k, g in gens.items():
            g.set_state(gen_states[k])

    def run(part, plain, book, gini):
        restore()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with plain_versions() if plain else contextlib.nullcontext(), \
                same_choices(book, record=not plain, near_ties=near_ties), \
                gini_inputs(*gini) if disagreement else contextlib.nullcontext():
            total, losses, _ = TrainStep(model, cfg).loss_and_grads(part, draw())
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        terms = {"total_loss": total.item(), **{k: v.item() for k, v in losses.items()}}
        graded = {n for n, p in model.named_parameters() if p.grad.abs().max() > 0}
        return terms, group_norms(model), graded, ms, torch.cuda.max_memory_allocated() / 2 ** 30

    n = batch["image"].shape[0]
    while True:
        part = {k: v[:n] for k, v in batch.items()}
        book, gini = {}, (([], []), ([], []))
        k_terms, k_norms, k_graded, k_ms, k_peak = run(part, False, book, gini[0])
        try:
            p_terms, p_norms, p_graded, p_ms, p_peak = run(part, True, book, gini[1])
            break
        except torch.cuda.OutOfMemoryError:
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            if n == 1:
                raise
            log(f"  {label}: the plain versions' step does not fit the card at batch {n}; "
                f"replayed at batch {n // 2}")
            n //= 2
    restore()
    model.zero_grad(set_to_none=True)
    worst = max(abs(k_terms[k] - p_terms[k]) / max(abs(p_terms[k]), 1e-6) for k in p_terms)
    group = {g: abs(k_norms[g] - p_norms[g]) / max(p_norms[g], 1e-12) for g in p_norms}
    missing = sorted(p_graded - k_graded)
    log(f"  {label} step at batch {n}, forward + criterion + backward: kernels {k_ms:.1f} ms "
        f"(peak {k_peak:.2f} GiB), plain versions {p_ms:.1f} ms (peak {p_peak:.2f} GiB) [first "
        f"call of each]; total loss kernels {k_terms['total_loss']:.6f} plain "
        f"{p_terms['total_loss']:.6f}; {len(k_terms)} loss terms, worst rel diff {worst:.3e}")
    log("  grad norm per group (kernels / plain): " + ", ".join(
        f"{g} {k_norms[g]:.5g}/{p_norms[g]:.5g}" for g in sorted(p_norms))
        + f"; worst rel diff {max(group.values()):.3e}")
    log(f"  parameters with a gradient: plain {len(p_graded)} of "
        f"{sum(1 for _ in model.parameters())}; of those, zero through the kernels: {len(missing)}")
    if disagreement:
        check_disagreement(f"{label} step", gini[0][1], gini[1][1], gini[0][0], gini[1][0])
    same_choices.check(f"{label} step", book, by_scores=("split tokens",) if disagreement else (),
                       floors=floors, near_tie_floors=near_tie_floors)
    if not all(math.isfinite(v) for v in k_terms.values()):
        raise SystemExit(f"{label} step: non-finite loss terms {k_terms}")
    if missing:
        raise SystemExit(f"{label} step: the kernel step gives no gradient to {missing[:10]}")
    if worst > loss_rtol:
        raise SystemExit(f"{label} step: loss terms of kernels and plain versions differ by "
                         f"{worst} (rel)")
    if max(group.values()) > group_rtol:
        raise SystemExit(f"{label} step: gradient norms per group disagree: {group}")
    return n, k_ms, p_ms, k_peak, p_peak


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

    replay_step("AFF-Mini", model, cfg, batch, draw)

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
        # card has), from the same weights, batch and generators; the plain
        # run replays the kernel run's discrete choices
        results, book = [], {}
        for path, record in ((contextlib.nullcontext, True), (plain_versions, False)):
            cfg_c = small_cfg(os.path.join(tmp, "c"), SMALL_PLAIN_BATCH)
            tr = Trainer(cfg_c, dev)
            batch = next(synthetic_batches(cfg_c, dev))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with path(), same_choices(book, record):
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
        same_choices.check(f"AFF-Small step at batch {SMALL_PLAIN_BATCH}", book)
        if rel > LOSS_RTOL:
            raise SystemExit(f"AFF-Small loss terms: kernels and plain versions differ by {rel}")
        if norm_rel > GROUP_NORM_RTOL:
            raise SystemExit("AFF-Small gradient norms per group: kernels and plain versions "
                             f"differ by {norm_rel} (rel)")
    return launches, k11


MASKFINER = "maskfiner_mini"


def maskfiner_launches(cfg) -> dict:
    """K1, K3 and K9 launches of one MaskFiner forward, from the config: a
    local attention per block of each cluster-attention stage (a
    MixResNeighbour or MixResNeighbourXAttn: every stage after the first in
    the published cascades, and a first one so named); an msdetrpc per
    encoder layer and transformer level; knn for each cluster-attention
    stage's clusters, each transformer level's 4-NN table, each FPN level's
    Shepard upsample and PointConv, and in the decoder the Shepard
    neighbours of each attended level (none where stage 0's one level is the
    mask features) and of the finest grid, once per forward."""
    mr, head = cfg.MODEL.MR, cfg.MODEL.MR_SEM_SEG_HEAD
    levels = cfg.MODEL.MASK_FINER.DECODER_LEVELS
    n_stages = len(mr.NAME)
    n_trans = len(head.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES)
    local_attn = msdetrpc = nn_calls = 0
    for li in range(n_stages):
        final = li == n_stages - 1
        trans = n_trans if final else min(li + 1, n_trans)
        fpn = (li + 1) - trans
        clustered = mr.NAME[li] in ("MixResNeighbour", "MixResNeighbourXAttn")
        local_attn += mr.DEPTHS[li] if clustered else 0
        msdetrpc += head.TRANSFORMER_ENC_LAYERS[li] * trans
        masked = not (li == 0 and levels[li] == 1)
        nn_calls += clustered + trans + 2 * fpn + (levels[li] if masked else 0) + 1
    return {"local_attn": local_attn, "msdetrpc": msdetrpc, "knn": nn_calls}


def path_forward_operands(model, images):
    """The operands of K1, K3 and K9 in one forward of a model (the cascade,
    or AFF + Mask2Former; under AMP on its bf16 view), in call order: {"local_attn": [(stage n, args)], "msdetrpc": [(idx, w, val,
    level sizes, 1)], "knn": [(label, query, database, k)]}.  Captured by
    wrapping the calls in models/aff.py, models/pixel_decoder.py and the
    kernel call inside geometry.knn.knn."""
    import torch
    from autofocusformermod_torch.geometry import knn as knn_mod
    from autofocusformermod_torch.models import aff, pixel_decoder
    from autofocusformermod_torch.parallel import precision

    calls = {"local_attn": [], "msdetrpc": [], "knn": []}
    real = (aff.sfc_cluster_attention, pixel_decoder.msdetrpc_levels_s, knn_mod._knn_cuda)

    def local_attn(*args, **kwargs):
        calls["local_attn"].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real[0](*args, **kwargs)

    def msdetrpc(idx, w, val, sizes):
        calls["msdetrpc"].append((idx.clone(), w.clone(), val.clone(), tuple(sizes), 1))
        return real[1](idx, w, val, sizes)

    def nn(query, database, k):
        calls["knn"].append((f"{len(calls['knn']):02d} q{query.shape[1]} db{database.shape[1]} "
                             f"k{k}", query.clone(), database.clone(), k))
        return real[2](query, database, k)

    aff.sfc_cluster_attention, pixel_decoder.msdetrpc_levels_s, knn_mod._knn_cuda = (
        local_attn, msdetrpc, nn)
    try:
        with torch.no_grad():
            precision.apply(model, images)
    finally:
        aff.sfc_cluster_attention, pixel_decoder.msdetrpc_levels_s, knn_mod._knn_cuda = real
    return calls


def check_local_attn_calls(label, calls):
    """K1 on captured calls [(q, k, v, pos, nc, w5, b5, blank_k, span)]: every
    call against the plain version within LOCAL_ATTN_ATOL; ms sums the
    calls' times, device_ms their time on the card alone (queued_ms),
    plain_ms the plain version's times, each call timed (median of 3)."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import sfc_cluster_attention

    err, ms, device_ms, plain_ms, bnd = 0.0, 0.0, 0.0, 0.0, {}
    for args in calls:
        q, pos, nc = args[0], args[3], args[4]
        b, h, n, c_ = q.shape
        out, blank = sfc_cluster_attention(*args)
        with plain_versions():
            rout, rblank = sfc_cluster_attention(*args)
            plain_ms += cuda_ms(lambda: sfc_cluster_attention(*args), iters=3, warmup=1)
        err = max(err, (out - rout).abs().max().item(), (blank - rblank).abs().max().item())
        ms += cuda_ms(lambda: sfc_cluster_attention(*args))
        device_ms += queued_ms(lambda: sfc_cluster_attention(*args))
        slots = nc.shape[-1] * args[8]
        bnd = add_bounds(bnd, bound(nbytes(*args[:8], out, blank, blank),
                                    b * h * n * slots * (4 * c_ + 10)))
        del out, blank, rout, rblank
    shapes = {}
    for args in calls:
        shapes[tuple(args[0].shape)] = shapes.get(tuple(args[0].shape), 0) + 1
    log(f"  local_attn {label}: {len(calls)} calls {shapes}: max_abs_err {err:.3e}; {ms:.3f} ms "
        f"in calls, {device_ms:.3f} on the card, plain {plain_ms:.3f}, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    if not err <= LOCAL_ATTN_ATOL:
        raise SystemExit(f"local_attn {label}: max abs err {err} > {LOCAL_ATTN_ATOL}")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "device_ms": device_ms,
            "calls": len(calls)}


def check_cascade(label, out, ref, book, gini):
    """A MaskFiner forward through the kernels against the plain run, which
    replayed the kernel run's choices: the final and every aux output
    within FORWARD_RTOL of its largest |entry| (at least 1), every stage's
    disagreement through its parts (check_disagreement; gini: the inputs of
    each stage's gini_disagreement in the two runs), the last stage's token
    positions equal."""
    import torch

    pairs = [("pred_logits", out["pred_logits"], ref["pred_logits"]),
             ("pred_masks", out["pred_masks"], ref["pred_masks"])]
    for i, (a, r) in enumerate(zip(out["aux_outputs"], ref["aux_outputs"])):
        pairs += [(f"aux {i} {key}", a[key], r[key]) for key in ("pred_logits", "pred_masks")]
    if len(out["aux_outputs"]) != len(ref["aux_outputs"]):
        raise SystemExit(f"{label}: {len(out['aux_outputs'])} aux outputs against "
                         f"{len(ref['aux_outputs'])}")
    worst = {}
    for key, a, r in pairs:
        if a.shape != r.shape or not torch.isfinite(a).all():
            raise SystemExit(f"{label} {key}: shape {tuple(a.shape)} against {tuple(r.shape)}, or "
                             "non-finite")
        e = (a - r).abs().max().item()
        rel = e / max(r.abs().max().item(), 1.0)
        kind = f"aux {key.split()[-1]}" if key.startswith("aux") else key
        worst[kind] = max(worst.get(kind, 0.0), rel)
        if rel > FORWARD_RTOL:
            raise SystemExit(f"{label} {key}: kernels and plain versions disagree by {e} "
                             f"({rel:.3e} of its largest entry)")
    log(f"    worst max_abs_err / max |ref| per output: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" ({len(pairs)} outputs, limit {FORWARD_RTOL})")
    check_disagreement(label, out["disagreement_masks"], ref["disagreement_masks"], *gini)
    if not torch.equal(out["features_pos"], ref["features_pos"]):
        raise SystemExit(f"{label}: the last stage's token positions differ")
    same_choices.check(label, book)
    return worst


def check_disagreement(label, out, ref, k_inputs, r_inputs):
    """Each stage's disagreement (out, ref) through its parts, computed from
    the inputs of gini_disagreement in the two runs [(mask logits, class
    logits)] with the kernel run's class votes (the plain run replayed
    them).  Each class's summed mask logits z are held to FORWARD_RTOL of
    their largest |entry| (at least 1).  The rest is ill-conditioned where
    z cancels (|z| reaches thousands while a token's z may be near 0), so
    each token is held to what its own max_c |dz| allows to first order:
    the mean of the present classes' sigmoids to 1/4 of it (a sigmoid's
    slope is at most 1/4), their mean absolute difference over all pairs to
    1/2, and the disagreement, 0.5 mad / mean, to 2 (each sigmoid's
    relative change is at most its logit's change, and the ratio's
    derivatives in the log-sigmoids sum to at most 2 in magnitude), each
    plus the rounding of its sums, GINI_ROUNDING_ATOL.  A stage's
    disagreement must have a nonzero entry unless one class has all its
    queries' votes in every image (then it is zero by definition)."""
    import torch
    from autofocusformermod_torch.models.maskfiner import gini_terms, predicted_classes

    if len(out) != len(ref) or len(k_inputs) != len(out) or len(r_inputs) != len(out):
        raise SystemExit(f"{label}: {len(out)} / {len(ref)} disagreements, {len(k_inputs)} / "
                         f"{len(r_inputs)} captured Gini inputs")
    for i, (d, dr, (km, kc), (rm, _)) in enumerate(zip(out, ref, k_inputs, r_inputs)):
        votes = predicted_classes(kc)
        (zk, mean_k, mad_k), (zr, mean_r, mad_r) = (gini_terms(m, votes, kc.shape[-1])
                                                    for m in (km, rm))
        z_rel = (zk - zr).abs().max().item() / max(zr.abs().max().item(), 1.0)
        dz = (zk - zr).abs().amax(dim=1)                                  # (b, n)
        share = {name: ((a - r).abs() / (slope * dz + GINI_ROUNDING_ATOL)).max().item()
                 for name, a, r, slope in (("mean", mean_k, mean_r, 0.25),
                                           ("mad", mad_k, mad_r, 0.5), ("disagreement", d, dr, 2.0))}
        classes = [int(torch.unique(v).numel()) for v in votes]
        log(f"    disagreement {i}: {tuple(d.shape)}, classes voted per image {classes}, max "
            f"{dr.max().item():.4g}, max_abs_err {(d - dr).abs().max().item():.3e}; z: max |z| "
            f"{zr.abs().max().item():.4g}, rel err {z_rel:.3e} (limit {FORWARD_RTOL}), max |dz| "
            f"{dz.max().item():.3e}; share of the bound from dz: "
            + ", ".join(f"{k} {v:.3f}" for k, v in share.items()))
        if not z_rel <= FORWARD_RTOL:
            raise SystemExit(f"{label} disagreement {i}: summed mask logits differ by {z_rel} "
                             "(rel)")
        if not max(share.values()) <= 1.0:
            raise SystemExit(f"{label} disagreement {i}: beyond the bound its inputs set: {share}")
        if max(classes) > 1 and not dr.max().item() > 0:
            raise SystemExit(f"{label} disagreement {i}: zero with {classes} classes voted")


class gini_inputs:
    """Within the block, the inputs of every gini_disagreement call (models/
    maskfiner.py) are appended to `store` as (mask logits, class logits),
    and its results to `results` where one is given."""

    def __init__(self, store, results=None):
        self.store, self.results = store, results

    def __enter__(self):
        from autofocusformermod_torch.models import maskfiner

        self.real = real = maskfiner.gini_disagreement

        def wrapped(outputs_mask, outputs_class):
            self.store.append((outputs_mask.detach().clone(), outputs_class.detach().clone()))
            out = real(outputs_mask, outputs_class)
            if self.results is not None:
                self.results.append(out.detach().clone())
            return out

        maskfiner.gini_disagreement = wrapped
        return self

    def __exit__(self, *exc):
        from autofocusformermod_torch.models import maskfiner

        maskfiner.gini_disagreement = self.real


def maskfiner_phase(dev, smi, gen):
    """Phase 11: the published MaskFiner-Mini (seeded random weights) at
    512x512.  K1, K3 and K9 on the operands of a real batch-4 forward, each
    against its plain version, with times and bounds; the batch-4 forward
    through the kernels (launch counts) and through the plain versions,
    replaying the kernel run's choices; ms per forward and device busy of
    both; the predictor at batch 1 and 4.  Returns ({kernel: record for
    by_path}, {kernel: launches of the forward})."""
    import contextlib

    import torch
    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.models.inference import SemanticPredictor
    from autofocusformermod_torch.models.maskformer import init_random_weights
    from autofocusformermod_torch.models.registry import build_model, size_divisibility
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import sfc_cluster_attention
    from autofocusformermod_torch.ops.msdetrpc import msdetrpc_levels_s
    from autofocusformermod_torch.tools.l2_rate import l2_read_rate

    cfg = PRESETS[MASKFINER]()
    model = build_model(cfg)
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(SEED + 2)).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {MASKFINER}: MR {cfg.MODEL.MR.NAME} EMBED_DIM {cfg.MODEL.MR.EMBED_DIM} DEPTHS "
        f"{cfg.MODEL.MR.DEPTHS}; CONVS_DIM {cfg.MODEL.MR_SEM_SEG_HEAD.CONVS_DIM}, encoder layers "
        f"{cfg.MODEL.MR_SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS}; DEC_LAYERS "
        f"{cfg.MODEL.MASK_FINER.DEC_LAYERS}; {n_params / 1e6:.1f} M parameters")

    # the kernels at the cascade's operands
    ops = path_forward_operands(model, images)
    paths = {"local_attn": check_local_attn_calls(MASKFINER, ops["local_attn"]),
             "msdetrpc": check_msdetrpc(MASKFINER, ops["msdetrpc"], l2_read_rate()),
             "knn": check_knn(MASKFINER, ops["knn"])}
    levels = sorted({(len(c[3]), c[0].shape[2], c[2].shape[2]) for c in ops["msdetrpc"]})
    log(f"  msdetrpc (levels, pairs, c_) of the forward: {levels}")
    del ops
    torch.cuda.empty_cache()

    # the forward through the kernels, then through the plain versions
    counters = {"local_attn": sfc_cluster_attention, "msdetrpc": msdetrpc_levels_s, "knn": knn}
    expected = maskfiner_launches(cfg)
    book, gini = {}, ([], [])
    with torch.no_grad():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        with same_choices(book, record=True), gini_inputs(gini[0]):
            out = model(images)
        torch.cuda.synchronize()
        t_first = (time.time() - t0) * 1e3
        launches = {name: c.launches for name, c in counters.items()}
        with same_choices(book, record=False), plain_versions(), gini_inputs(gini[1]):
            ref = model(images)
        again = model(images)
    same = all(torch.equal(a, b) for a, b in zip(
        [out["pred_logits"], out["pred_masks"], *out["disagreement_masks"]],
        [again["pred_logits"], again["pred_masks"], *again["disagreement_masks"]]))
    log(f"  a second forward through the kernels equals the first bit for bit: {same}")
    del again
    tps = [tuple(d.shape) for d in out["disagreement_masks"]]
    log(f"  batch-{BATCH} forward: {t_first:.1f} ms (first call); launches {launches} (expected "
        f"{expected}); disagreement shapes {tps}; pred_masks {tuple(out['pred_masks'].shape)}")
    if launches != expected:
        raise SystemExit(f"{MASKFINER} forward launched {launches}, expected {expected}")
    if tuple(out["pred_logits"].shape) != (BATCH, 100, 151) or \
            tuple(out["pred_masks"].shape) != (BATCH, 100, SIZE // 4, SIZE // 4):
        raise SystemExit(f"{MASKFINER}: outputs {tuple(out['pred_logits'].shape)}, "
                         f"{tuple(out['pred_masks'].shape)}")
    check_cascade(f"{MASKFINER} forward", out, ref, book, gini)
    del out, ref, book, gini

    def forward_ms(run_path):
        def run():
            with run_path(), torch.no_grad():
                model(images)
            torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.time()
            run()
            times.append((time.time() - t0) * 1e3)
        return statistics.median(times[1:]), *device_busy(run, runs=2)

    k_ms, k_busy, k_rows = forward_ms(contextlib.nullcontext)
    p_ms, p_busy, p_rows = forward_ms(plain_versions)
    log(f"  ms per batch-{BATCH} forward (median of 4 after one): kernels {k_ms:.2f} (device "
        f"busy {k_busy:.2f} ms in {k_rows:.0f} rows), plain versions {p_ms:.2f} (busy "
        f"{p_busy:.2f} ms in {p_rows:.0f} rows) ({smi})")

    predictor = SemanticPredictor(model, size_divisibility(cfg))
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
                raise SystemExit(f"{MASKFINER} predictor: bad label map {tuple(lab.shape)} "
                                 f"[{lab.min()}, {lab.max()}]")
        log(f"  predictor batch {bs}: {len(reqs)} images in {dt:.3f} s = {len(reqs) / dt:.2f} "
            f"images/s ({smi}); label maps {tuple(labels[0].shape)}")
    del model, images, predictor
    torch.cuda.empty_cache()
    return paths, launches


def maskfiner_step_launches(cfg, size=SIZE) -> dict:
    """Every kernel's launches in one MaskFiner training step, from the
    config: the forward's K1, K3 and K9 (maskfiner_launches) and a K2 and a
    K4 backward for each K1 and K3 call; for each of the criterion's mask
    shapes (stage s's masks are size / PATCH_SIZES[s] a side) a K10 read of
    the targets, one of the matched logits and the logits' backward, and
    the ranking read through K12 where the stratified route's rule takes it
    (point_sample_nearest_rows_supported) and through K11 elsewhere; one K13
    solve, as every layer's cost has the shape (b, queries, target slots)."""
    from autofocusformermod_torch.losses import point_sample as sampler
    from autofocusformermod_torch.ops.point_sample import point_sample_nearest_rows_supported

    fwd = maskfiner_launches(cfg)
    mf = cfg.MODEL.MASK_FINER
    sides = sorted({size // p for p in cfg.MODEL.MR.PATCH_SIZES})
    cand = int(mf.TRAIN_NUM_POINTS * mf.OVERSAMPLE_RATIO)
    rows = sum(bool(sampler.STRATIFY_RANKING and point_sample_nearest_rows_supported(s, s, cand))
               for s in sides)
    return {"local_attn": fwd["local_attn"], "local_attn_bwd": fwd["local_attn"],
            "msdetrpc": fwd["msdetrpc"], "msdetrpc_bwd": fwd["msdetrpc"], "knn": fwd["knn"],
            "point_sample": 2 * len(sides), "point_sample_bwd": len(sides),
            "point_sample_nearest": len(sides) - rows, "point_sample_nearest_rows": rows,
            "lapjv": 1}


def path_maskfiner_step_operands(model, cfg, batch, draw):
    """The operands of K2, K4, K10, K11, K12 and K13 in one MaskFiner
    training step's forward, criterion and backward (TrainStep.
    loss_and_grads), in call order: {"local_attn_bwd": [the arguments of
    sfc_cluster_attention_backward], "msdetrpc_bwd": [(idx_s, w_s, val,
    level sizes, 1, g)], "point_sample": {mask side: {"targets": (masks,
    coords), "logits": (masks, coords, g)}}, "point_sample_nearest":
    [(masks, coords)], "point_sample_nearest_rows": [(masks, cx, cy)],
    "lapjv": [cost]}.  Captured by wrapping the backward launchers that the
    autograd Functions call (ops/local_attn.py, ops/msdetrpc.py), the
    criterion's point_sample_auto (the logits' gradient by a hook) and
    solve_lsap, and the two nearest reads the sampler takes from
    ops/point_sample.py."""
    import torch
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses import criterion
    from autofocusformermod_torch.ops import local_attn, msdetrpc
    from autofocusformermod_torch.ops import point_sample as ops_ps

    ops = {"local_attn_bwd": [], "msdetrpc_bwd": [], "point_sample": [],
           "point_sample_nearest": [], "point_sample_nearest_rows": [], "lapjv": []}

    def clone(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    def keep(name, real):
        def wrapped(*args):
            ops[name].append(tuple(clone(a) for a in args))
            return real(*args)
        # a launcher counts through its module's name, which is this wrapper now
        wrapped.__dict__.update(real.__dict__)
        return wrapped

    def sample(real):
        def wrapped(masks, coords):
            out = real(masks, coords)
            entry = [clone(masks), clone(coords), None]
            ops["point_sample"].append(entry)
            if out.requires_grad:
                out.register_hook(lambda g: entry.__setitem__(2, g.detach().clone()))
            return out
        return wrapped

    sites = [(local_attn, "sfc_cluster_attention_backward", "local_attn_bwd"),
             (msdetrpc, "msdetrpc_levels_s_backward", "msdetrpc_bwd"),
             (ops_ps, "point_sample_nearest", "point_sample_nearest"),
             (ops_ps, "point_sample_nearest_rows", "point_sample_nearest_rows"),
             (criterion, "solve_lsap", "lapjv"), (criterion, "point_sample_auto", None)]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in sites]
    for owner, name, key in sites:
        real = getattr(owner, name)
        setattr(owner, name, keep(key, real) if key else sample(real))
    try:
        TrainStep(model, cfg).loss_and_grads(batch, draw)
    finally:
        for owner, name, real in saved:
            if hasattr(real, "launches"):
                real.launches = getattr(owner, name).launches
            setattr(owner, name, real)
    model.zero_grad(set_to_none=True)
    ops["msdetrpc_bwd"] = [(idx, w, val, sizes, 1, g) for idx, w, val, g, sizes in ops["msdetrpc_bwd"]]
    calls, groups = ops["point_sample"], {}
    if len(calls) % 2 or any(t[2] is not None or lg[2] is None
                             for t, lg in zip(calls[0::2], calls[1::2])):
        raise SystemExit(f"the criterion made {len(calls)} point_sample calls; expected a "
                         "targets' (no gradient) and a logits' (with one) per mask shape")
    for (tm, tc, _), (lm, lc, lg) in zip(calls[0::2], calls[1::2]):
        groups[lm.shape[-1]] = {"targets": (tm, tc), "logits": (lm, lc, lg)}
    ops["point_sample"] = groups
    return ops


def check_local_attn_bwd_calls(label, calls):
    """K2 on captured backward calls [(q, k, v, pos, nc, w5, b5, g, lse, delta,
    cluster size, reverse lists)]: dq, dk, dv and the bias rows of the
    kernel pair against the plain version, within GRAD_RTOL of each
    gradient's largest entry (at least 1), and two calls bit for bit; ms
    sums the calls' times, device_ms their time on the card alone
    (queued_ms), plain_ms the plain version's, each call timed."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.local_attn import sfc_cluster_attention_backward as bwd

    err, worst, ms, device_ms, plain_ms, bnd, shapes = 0.0, 0.0, 0.0, 0.0, 0.0, {}, {}
    for args in calls:
        q, nc = args[0], args[4]
        b, h, n, c_ = q.shape
        got, again = bwd(*args), bwd(*args)
        if not all(torch.equal(a, r) for a, r in zip(got, again)):
            raise SystemExit(f"local_attn backward {label} q={tuple(q.shape)}: two calls on the "
                             "same inputs differ")
        with plain_versions():
            want = bwd(*args)
            plain_ms += cuda_ms(lambda: bwd(*args), iters=3, warmup=1)
        e, rel = grad_errs(got, want)
        err, worst = max(err, e), max(worst, rel)
        ms += cuda_ms(lambda: bwd(*args))
        device_ms += queued_ms(lambda: bwd(*args))
        # per (query, head, neighbour slot): q.k again, g.v, and the three
        # products into dq, dk, dv (10 c_), and the bias and its gradient (20)
        slots = nc.shape[-1] * args[10]
        bnd = add_bounds(bnd, bound(nbytes(*args[:10], *got), b * h * n * slots * (10 * c_ + 20)))
        shapes[tuple(q.shape)] = shapes.get(tuple(q.shape), 0) + 1
        del got, again, want
    log(f"  local_attn bwd {label}: {len(calls)} calls {shapes}: max_abs_err {err:.3e} (rel "
        f"{worst:.3e}; dq dk dv drow), bit-identical twice; {ms:.3f} ms in calls, "
        f"{device_ms:.3f} on the card, plain {plain_ms:.3f}, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']})")
    if not worst <= GRAD_RTOL:
        raise SystemExit(f"local_attn backward {label}: max rel err {worst} > {GRAD_RTOL}")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "device_ms": device_ms,
            "calls": len(calls)}


def summed(records: dict) -> dict:
    """One record of several calls' records {label: record}: the worst
    error, the times and bounds summed (library_ms where every call has
    one), each call's own under "by_call"."""
    bnd = {}
    for r in records.values():
        bnd = add_bounds(bnd, r)
    libs = [r.get("library_ms") for r in records.values()]
    return {"max_abs_err": max(r["max_abs_err"] for r in records.values()),
            "ms": sum(r["ms"] for r in records.values()),
            "plain_ms": sum(r["plain_ms"] for r in records.values()),
            "library_ms": None if None in libs else sum(libs), **bnd, "by_call": records}


MASKFINER_TRAIN, MASKFINER_TRAIN_BATCH, MASKFINER_TRAIN_STEPS = "maskfiner_mini_train", 4, 3
MASKFINER_CLI_STEPS, MASKFINER_RESUME_AT = 4, 2


def maskfiner_train_phase(dev, smi, gen, counters):
    """Phase 13: the published MaskFiner-Mini's training step at 512x512,
    batch MASKFINER_TRAIN_BATCH (seeded random weights, synthetic label
    maps, 100 target slots).  K2, K4, K10 (per mask shape), K11, K12 and K13
    on the operands of one real step, each against its plain version;
    MASKFINER_TRAIN_STEPS steps through the kernels, each replayed through
    the plain versions from the same weights, optimizer state, batch and
    draws (loss terms to LOSS_RTOL, gradient norms per group to
    GROUP_NORM_RTOL, each stage's disagreement through its parts as phase 11
    holds it, which holds the split order that follows from it; the other
    choices to CHOICE_AGREE_MIN), with every kernel's launches per step
    against maskfiner_step_launches, K10 by route, ms per step, device busy
    and peak memory; then train_net in this process: MASKFINER_CLI_STEPS
    steps with checkpoints and test() on two in-memory images after the
    last, and a second run that replays the first's choices, stopped at
    step MASKFINER_RESUME_AT (its state restored bit for bit by a fresh
    Trainer) and resumed to the end, whose loss terms are held to the first
    run's as phase 8 holds them.  Returns ({kernel: record for by_path},
    {counter: launches of the phase's runs through the kernels})."""
    import copy
    import json
    import math
    import os
    import tempfile

    import torch
    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.maskformer import init_random_weights
    from autofocusformermod_torch.models.registry import build_model
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.point_sample import point_sample_backward, point_sample_bilinear

    b, label = MASKFINER_TRAIN_BATCH, MASKFINER_TRAIN
    cfg = PRESETS[MASKFINER]()
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", str(b)])
    mf = cfg.MODEL.MASK_FINER
    log(f"  {MASKFINER} step: batch {b} x {SIZE}x{SIZE}, {cfg.TPU.MAX_GT_INSTANCES} target slots, "
        f"{mf.TRAIN_NUM_POINTS} points; loss weights class {mf.CLASS_WEIGHT} mask "
        f"{mf.MASK_WEIGHT} dice {mf.DICE_WEIGHT} no-object {mf.NO_OBJECT_WEIGHT} "
        f"(MODEL.MASK_FINER), {cfg.MODEL.MR_SEM_SEG_HEAD.NUM_CLASSES} classes, clip "
        f"{cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE}")
    model = build_model(cfg)
    init_random_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).train()
    batches = synthetic_batches(cfg, dev)
    expected = maskfiner_step_launches(cfg)
    expected = {n: expected.get(n, 0) for n in counters}
    sides = sorted({SIZE // p for p in cfg.MODEL.MR.PATCH_SIZES})
    total = dict.fromkeys(counters, 0)

    def reset():
        for c in counters.values():
            c.launches = 0

    def add():
        got = {name: c.launches for name, c in counters.items()}
        for name, n in got.items():
            total[name] += n
        return got

    def draw(i):
        return device_draw(torch.Generator(device=dev).manual_seed(SEED + i))

    # the kernels at the operands of one real step
    batch = next(batches)
    ops = path_maskfiner_step_operands(model, cfg, batch, draw(0))
    paths = {"local_attn_bwd": check_local_attn_bwd_calls(label, ops.pop("local_attn_bwd")),
             "msdetrpc_bwd": msdetrpc_bwd_calls(label, ops.pop("msdetrpc_bwd"), gen)}
    torch.cuda.empty_cache()
    groups = ops.pop("point_sample")
    if sorted(groups) != sides:
        raise SystemExit(f"{label}: the criterion sampled masks of sides {sorted(groups)}, "
                         f"expected {sides}")
    by_side = {}
    for side in sides:
        by_side[f"{side}x{side}"] = point_sample_calls(f"{label} {side}x{side}", groups.pop(side),
                                                       gen)
        torch.cuda.empty_cache()
    paths["point_sample"] = summed(by_side)
    for name in ("point_sample_nearest", "point_sample_nearest_rows"):
        calls = ops.pop(name)
        if len(calls) != expected[name]:
            raise SystemExit(f"{label}: the ranking read {len(calls)} times through {name}, "
                             f"expected {expected[name]}")
        fn = counters[name]
        paths[name] = summed({f"{c[0].shape[-1]}x{c[0].shape[-1]}": hold_nearest(
            f"{label} {c[0].shape[-1]}x{c[0].shape[-1]}", fn, c[0], c[1:]) for c in calls})
        del calls
        torch.cuda.empty_cache()
    paths["lapjv"] = lapjv_costs(label, ops.pop("lapjv")[0][0])
    del ops
    torch.cuda.empty_cache()

    # steps through the kernels, each replayed through the plain versions
    step = TrainStep(model, cfg)

    def snapshot():
        return copy.deepcopy({"model": model.state_dict(), "optimizer": step.optimizer.state_dict(),
                              "scheduler": step.scheduler.state_dict()})

    def restore(state):
        model.load_state_dict(state["model"])
        step.optimizer.load_state_dict(state["optimizer"])
        step.scheduler.load_state_dict(state["scheduler"])

    def terms_of(total_loss, losses):
        return {"total_loss": total_loss.item(), **{k: v.item() for k, v in losses.items()}}

    def worst_rel(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in b)

    routes = (point_sample_bilinear, point_sample_backward, counters["point_sample_nearest"])
    times, peaks, p_times, p_peaks = [], [], [], []
    for i in range(MASKFINER_TRAIN_STEPS):
        batch, book, gini = next(batches), {}, (([], []), ([], []))
        before = snapshot()
        by_route = [dict(fn.launches_by_route) for fn in routes]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.time()
        with same_choices(book, record=True), gini_inputs(*gini[0]):
            terms = terms_of(*step.loss_and_grads(batch, draw(i + 1))[:2])
        dt = time.time() - t0
        norms = group_norms(model)
        t0 = time.time()
        grad_norm = step.apply_gradients().item()
        times.append(dt + time.time() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        got = add()
        by_route = [{r: fn.launches_by_route[r] - n[r] for r in n} for fn, n in zip(routes, by_route)]
        after = snapshot()
        restore(before)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with same_choices(book, record=False), plain_versions(), gini_inputs(*gini[1]):
            p_terms = terms_of(*step.loss_and_grads(batch, draw(i + 1))[:2])
        torch.cuda.synchronize()
        p_times.append(time.time() - t0)
        p_peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        p_norms = group_norms(model)
        restore(after)
        del before, after
        rel, norm_rel = worst_rel(terms, p_terms), worst_rel(norms, p_norms)
        log(f"  step {i + 1}: total loss {terms['total_loss']:.6f} (plain "
            f"{p_terms['total_loss']:.6f}), {len(terms) - 1} loss terms worst rel diff {rel:.3e}, "
            f"grad norms per group worst rel diff {norm_rel:.3e}, grad_norm {grad_norm:.5f}; "
            f"{times[-1] * 1e3:.1f} ms (peak {peaks[-1]:.2f} GiB), plain forward + criterion + "
            f"backward {p_times[-1] * 1e3:.1f} ms (peak {p_peaks[-1]:.2f} GiB)")
        log(f"    launches {got}; point_sample by route: forward {by_route[0]}, backward "
            f"{by_route[1]}; the ranking through point_sample_nearest "
            f"{got['point_sample_nearest']} (by route {by_route[2]}), point_sample_nearest_rows "
            f"{got['point_sample_nearest_rows']}")
        # the split order follows each stage's disagreement, whose ties are
        # exact in one run where its sigmoids saturate and broken by rounding
        # in the other: the disagreement is held to the bound its inputs'
        # differences set, and the order, a function of it, through it
        check_disagreement(f"{label} step {i + 1}", gini[0][1], gini[1][1], gini[0][0],
                           gini[1][0])
        same_choices.check(f"{label} step {i + 1}", book, by_scores=("split tokens",))
        if got != expected:
            raise SystemExit(f"{label} step {i + 1}: launched {got}, expected {expected}")
        if by_route != [{"direct": len(sides), "shared": len(sides)},
                        {"direct": 0, "shared": len(sides)},
                        {"direct": 0, "shared": expected["point_sample_nearest"]}]:
            raise SystemExit(f"{label} step {i + 1}: point_sample and point_sample_nearest took "
                             f"the routes {by_route}; the targets belong to the direct route, "
                             "every logits group, its backward and its ranking read to the "
                             "shared one")
        if len(terms) != 1 + 3 * 19 or not all(math.isfinite(v) for v in terms.values()):
            raise SystemExit(f"{label} step {i + 1}: {len(terms) - 1} loss terms, or non-finite")
        if rel > LOSS_RTOL or norm_rel > GROUP_NORM_RTOL:
            raise SystemExit(f"{label} step {i + 1}: loss terms differ by {rel}, gradient norms "
                             f"by {norm_rel} (rel) from the plain versions'")
        del batch, book, gini
        torch.cuda.empty_cache()
    ms = statistics.median(times[1:]) * 1e3

    def one_step():
        step(next(batches), draw(0))
        torch.cuda.synchronize()

    busy, rows = device_busy(one_step, runs=2)
    log(f"  ms per step (median of steps 2-{MASKFINER_TRAIN_STEPS}): {ms:.1f} = "
        f"{b / ms * 1e3:.2f} images/s at batch {b}, peak {max(peaks):.2f} GiB; device busy "
        f"{busy:.2f} ms per step in {rows:.0f} rows ({busy / ms:.0%} of the step); plain "
        f"versions' forward + criterion + backward {statistics.median(p_times[1:]) * 1e3:.1f} ms, "
        f"peak {max(p_peaks):.2f} GiB ({smi})")
    del step, model
    torch.cuda.empty_cache()

    # train_net: an uninterrupted run, then one stopped and resumed.  The
    # split's near-tied disagreements turn the last-bit differences of the
    # atomics in two runs' backwards into other split tokens within a step
    # (seen: 1.3e-2 in the loss terms at step 2), so the second run replays
    # the first's choices and is held as phase 8 holds its resumed run
    test_set = ("DATASETS.TEST", f"('{EVAL_NAMES[2]}',)")

    def opts(out_dir):
        return ["TEST.EVAL_PERIOD", str(MASKFINER_CLI_STEPS), "SOLVER.IMS_PER_BATCH", str(b),
                "OUTPUT_DIR", out_dir, *test_set]

    def cli(out_dir, max_iter, resume=False):
        argv = ["--config", MASKFINER, "--synthetic", "--max-iter", str(max_iter)]
        return train_net.main(argv + (["--resume"] if resume else []) + opts(out_dir))

    def metrics_of(out_dir):
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            return {m["step"]: m for m in map(json.loads, f)}

    def loss_terms(m):
        return {k: v for k, v in m.items() if k.startswith("loss_") or k == "total_loss"}

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="maskfiner_") as tmp, \
            semantic_files(eval_dataset(EVAL_SIZES[:2])):
        dir_a, dir_b, book = os.path.join(tmp, "a"), os.path.join(tmp, "b"), {}
        reset()
        with same_choices(book, record=True):
            whole_run = cli(dir_a, MASKFINER_CLI_STEPS)
        got = add()
        per_image = maskfiner_launches(cfg)
        want = {n: v * MASKFINER_CLI_STEPS + 2 * per_image.get(n, 0) for n, v in expected.items()}
        whole = metrics_of(dir_a)
        log(f"  train_net --config {MASKFINER} --synthetic --max-iter {MASKFINER_CLI_STEPS}, test() "
            f"after the last step: " + ", ".join(
                f"step {s} {m['seconds'] * 1e3:.1f} ms loss {m['total_loss']:.5f}"
                for s, m in sorted(whole.items()))
            + f"; mIoU {whole_run.results[EVAL_NAMES[2]]['mIoU']:.4f}; launches {got} (expected "
            f"{want}: {MASKFINER_CLI_STEPS} steps and two test images)")
        if sorted(whole) != list(range(1, MASKFINER_CLI_STEPS + 1)) or got != want:
            raise SystemExit(f"{MASKFINER} through train_net: steps {sorted(whole)}, launches "
                             f"{got} (expected {want})")
        del whole_run
        reset()
        with same_choices(book, record=False):
            first = cli(dir_b, MASKFINER_RESUME_AT)
            saved = copy.deepcopy(first.state(MASKFINER_RESUME_AT))
            del first
            fresh_cfg = PRESETS[MASKFINER]()
            fresh_cfg.merge_from_list(opts(dir_b))
            fresh = Trainer(fresh_cfg, dev)
            fresh.resume_or_load(resume=True)
            same = {part: same_tree(saved[part], fresh.state(fresh.start_step)[part])
                    for part in saved}
            del fresh
            resumed = cli(dir_b, MASKFINER_CLI_STEPS, resume=True)
        add()
        n_moments = sum(1 for st in saved["optimizer"]["state"].values() if st["exp_avg"].abs().max() > 0)
        log(f"  a run stopped after step {MASKFINER_RESUME_AT}: a fresh Trainer restores its state bit "
            f"for bit: {same} ({len(saved['model'])} model tensors, {n_moments} nonzero AdamW first "
            f"moments, schedule at {saved['scheduler']['last_epoch']}); resumed to step "
            f"{resumed.start_step}, replaying the first run's choices, which its own equal in "
            + "; ".join(f"{k} {e}/{n}" for k, (e, n) in book["agree"].items()))
        if not all(same.values()) or saved["scheduler"]["last_epoch"] != MASKFINER_RESUME_AT \
                or not n_moments or resumed.start_step != MASKFINER_CLI_STEPS:
            raise SystemExit(f"{MASKFINER}: the resumed state differs from the stopped run's "
                             f"({same}) or the run ended at step {resumed.start_step}")
        again, before = metrics_of(dir_b), 0.0
        for s in range(1, MASKFINER_CLI_STEPS + 1):
            rel = worst_rel(loss_terms(again[s]), loss_terms(whole[s]))
            limit = max(RESUME_RTOL, RESUME_GROWTH * before)
            log(f"  step {s}{' (resumed)' if s > MASKFINER_RESUME_AT else ''}: loss terms against "
                f"the uninterrupted run: worst rel diff {rel:.3e} (limit {limit:.1e})")
            if rel > limit:
                raise SystemExit(f"{MASKFINER} step {s}: the two runs' loss terms differ by {rel} "
                                 f"(rel), limit {limit}")
            before = max(before, rel)
        miou = resumed.results[EVAL_NAMES[2]]["mIoU"]
        log(f"  the resumed run's test() on {EVAL_NAMES[2]} after step {MASKFINER_CLI_STEPS}: mIoU "
            f"{miou:.4f}")
        if not math.isfinite(miou):
            raise SystemExit(f"{MASKFINER}: the resumed run's test() gave mIoU {miou}")
        del resumed, saved
    torch.cuda.empty_cache()
    return paths, total


# the evaluation phase (12): ADE20K-shaped images and label maps made from a
# numpy seed -- (height, width) of each pair -- at the aspect ratios of the
# published evaluation (short edge 512, long edge at most 2048, padded to 32)
EVAL_SIZES = ((512, 683), (300, 400), (768, 1024), (480, 1600), (640, 480), (512, 512),
              (256, 1024), (200, 1000), (375, 500), (427, 640), (683, 512), (600, 800))
EVAL_PRESET, EVAL_STEPS, EVAL_PERIOD, EVAL_BATCH = "aff_mini", 4, 2, 8
# phase 12's models and phase 14's panoptic one run one block a stage
# (published widths): they hold the dataset, evaluation and post-processing
# paths, which depth does not change, and the script's time limit needs the
# room (phase 14's COCO-instance model keeps its depth: cut, it makes no
# detection after its 2 steps, and its AP check needs some)
ONE_BLOCK_AFF = ["MODEL.AFF.DEPTHS", "[1, 1, 1, 1]"]
ONE_BLOCK_MR = ["MODEL.MR.DEPTHS", "[1, 1, 1, 1]"]
# the datasets phase 12 registers: training, test, and the test set's first
# two pairs (MaskFiner-Mini's --eval-only)
EVAL_NAMES = ("smoke_ade20k_train", "smoke_ade20k_val", "smoke_ade20k_val_2")
# the test images whose forwards' K1, K3 and K9 operands are held against the
# plain versions (mapped to 512x2048 and 410x2048: 65,536 and 53,248
# first-stage tokens; the second's last decoder level no multiple of 128)
EVAL_KERNEL_SIZES = ((256, 1024), (200, 1000))


def eval_dataset(sizes=EVAL_SIZES, seed=SEED):
    """{file name: (image (h, w, 3) uint8, label map (h, w) int64)}: smooth
    random images, label maps of 32-pixel blocks over 8-30 of the 150
    classes with two rectangles of the ignore label (255)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pairs = {}
    for i, (h, w) in enumerate(sizes):
        coarse = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float64)
        img = coarse.repeat(16, 0).repeat(16, 1)[:h, :w] + rng.normal(0, 12, (h, w, 3))
        k = int(rng.integers(8, 31))
        classes = rng.choice(150, k, replace=False)
        cells = classes[rng.integers(0, k, (h // 32 + 1, w // 32 + 1))]
        sem = cells.repeat(32, 0).repeat(32, 1)[:h, :w].astype(np.int64)
        for _ in range(2):
            y, x = int(rng.integers(0, h - 40)), int(rng.integers(0, w - 40))
            sem[y: y + int(rng.integers(8, 40)), x: x + int(rng.integers(8, 40))] = 255
        pairs[f"smoke/{i:02d}_{h}x{w}.jpg"] = (np.clip(img, 0, 255).astype(np.uint8), sem)
    return pairs


class in_memory_files:
    """Register `datasets` {name: (dataset dicts, metadata)} and replace
    file readers of the data package by lookups in memory: `readers`
    {(module, function name): {path: array}}.  The card's machine has no
    PIL, so only the readers are replaced; everything after reading is the
    package's own code."""

    def __init__(self, datasets, readers):
        self.datasets, self.readers = datasets, readers

    def __enter__(self):
        import importlib

        from autofocusformermod_torch.data.catalog import DatasetCatalog, MetadataCatalog

        for name, (dicts, meta) in self.datasets.items():
            DatasetCatalog.register(name, lambda dicts=dicts: [dict(d) for d in dicts])
            MetadataCatalog.get(name).set(**meta)
        self.saved = []
        for (module, name), files in self.readers.items():
            owner = importlib.import_module(module)
            self.saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, files.__getitem__)
        return self

    def __exit__(self, *exc):
        from autofocusformermod_torch.data.catalog import DatasetCatalog

        for owner, name, real in self.saved:
            setattr(owner, name, real)
        for name in self.datasets:
            DatasetCatalog.remove(name)


def semantic_files(pairs):
    """`pairs` {image file: (image, label map)} registered under EVAL_NAMES
    (the third with the first two images) for the semantic mapper."""
    from autofocusformermod_torch.data.datasets import ADE20K_SEM_SEG_CATEGORIES

    files = [{"file_name": f, "sem_seg_file_name": f[:-4] + ".png"} for f in pairs]
    meta = {"stuff_classes": ADE20K_SEM_SEG_CATEGORIES, "ignore_label": 255,
            "evaluator_type": "sem_seg"}
    module = "autofocusformermod_torch.data.mapper_semantic"
    return in_memory_files(
        {name: (subset, meta) for name, subset in zip(EVAL_NAMES, (files, files, files[:2]))},
        {(module, "read_image"): {f: img for f, (img, _) in pairs.items()},
         (module, "read_sem_seg"): {f[:-4] + ".png": sem for f, (_, sem) in pairs.items()}})


def counted_call(counters, fn):
    """(fn(), its ms between synchronisations of the card, {counter:
    launches within it})."""
    import torch

    before = {n: f.launches for n, f in counters.items()}
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3, {n: f.launches - before[n] for n, f in counters.items()}


class watch_eval:
    """Within the block: every test() image's class scores (kept where
    `keep`), its time on the card and its padded input size; the launches of
    `counters` per image; the pad fringe of the model's input, read by a
    forward pre-hook on every Trainer's model; the loader's host batches; and
    each evaluator's confusion matrix.  A Trainer made within a watch keeps
    its hook, which reads the watch active at the time."""

    active = None

    def __init__(self, counters, keep=False):
        self.counters, self.keep = counters, keep
        self.images, self.batches, self.confs = [], [], []
        self.fringe = [0, 0]                  # pixels checked, pixels off the mean
        self.current = None

    def __enter__(self):
        import numpy as np
        import torch
        from autofocusformermod_torch.data.loader import TrainLoader
        from autofocusformermod_torch.engine.train import Trainer
        from autofocusformermod_torch.evaluation.sem_seg_evaluation import SemSegEvaluator

        self.saved = [(Trainer, "__init__"), (Trainer, "eval_scores"), (TrainLoader, "__next__"),
                      (SemSegEvaluator, "evaluate")]
        self.saved = [(o, n, getattr(o, n)) for o, n in self.saved]
        (_, _, init), (_, _, scores), (_, _, nxt), (_, _, evaluate) = self.saved
        watch = watch_eval.active = self

        def hook(model, args):
            watch = watch_eval.active
            if watch is None or watch.current is None:
                return
            x, (h, w) = args[0], watch.current["hw"]
            mean = torch.tensor(watch.current["mean"], dtype=x.dtype, device=x.device)
            watch.current["input"] = tuple(x.shape[1:3])
            fringe = torch.cat([x[0, h:].reshape(-1, 3), x[0, :, w:].reshape(-1, 3)])
            watch.fringe[0] += fringe.shape[0]
            watch.fringe[1] += int((fringe != mean).any(-1).sum())

        def init_(self, *a, **k):
            init(self, *a, **k)
            self.model.register_forward_pre_hook(hook)

        def eval_scores(self, image, out_hw):
            watch.current = {"hw": image.shape[:2], "out_hw": tuple(out_hw),
                             "mean": np.round(self.cfg.MODEL.PIXEL_MEAN).tolist()}
            sem, ms, launches = counted_call(watch.counters, lambda: scores(self, image, out_hw))
            rec, watch.current = watch.current, None
            rec["ms"], rec["launches"] = ms, launches
            rec["scores"] = sem if watch.keep else None
            watch.images.append(rec)
            return sem

        def next_(self):
            batch = nxt(self)
            watch.batches.append({k: batch[k].copy() for k in ("image", "sem_seg_map", "labels",
                                                                 "valid")})
            return batch

        def evaluate_(self):
            watch.confs.append((self.num_classes, self._conf.copy()))
            return evaluate(self)

        for (owner, name, _), fn in zip(self.saved, (init_, eval_scores, next_, evaluate_)):
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc):
        watch_eval.active = None
        for owner, name, real in self.saved:
            setattr(owner, name, real)


def check_loader_batches(batches, ignore=255):
    """The loader's host batches: shapes and dtypes, the ignore label under
    the pad (rows and columns where the image is the pad value 128 in every
    channel), and the labels of each sample equal to its map's classes."""
    import numpy as np

    padded = 0
    for b in batches:
        img, sem, labels, valid = b["image"], b["sem_seg_map"], b["labels"], b["valid"]
        shapes = (img.shape, img.dtype, sem.shape, sem.dtype, labels.shape, labels.dtype,
                  valid.dtype)
        want = ((EVAL_BATCH, 512, 512, 3), np.uint8, (EVAL_BATCH, 512, 512), np.uint8,
                (EVAL_BATCH, 100), np.int32, np.bool_)
        if shapes != want:
            raise SystemExit(f"loader batch {shapes}, expected {want}")
        for i in range(EVAL_BATCH):
            pad = (img[i] == 128).all(-1)
            rows, cols = pad.all(1), pad.all(0)
            bottom = int(np.argmin(rows[::-1])) if not rows.all() else 512
            right = int(np.argmin(cols[::-1])) if not cols.all() else 512
            if bottom or right:
                padded += 1
                if (sem[i, 512 - bottom:] != ignore).any() or (sem[i, :, 512 - right:] != ignore).any():
                    raise SystemExit("loader batch: the pad region's labels are not the ignore label")
            present = np.unique(sem[i])
            present = present[present != ignore][:100]
            if not (np.array_equal(labels[i][valid[i]], present) and valid[i].sum() == len(present)
                    and not valid[i][len(present):].any()):
                raise SystemExit(f"loader batch: labels {labels[i][valid[i]]} of a map with classes "
                                 f"{present}")
    if not padded:
        raise SystemExit("no loader sample was padded: the pad check saw nothing")
    return padded


def check_eval_run(label, watch, pairs, expected, eval_sizes):
    """One test() run's images: launches per image, the pad fringe, and the
    confusion matrix against the round-tripped ground truth at the original
    size.  Returns {padded input size: [ms]}."""
    import numpy as np
    from autofocusformermod_torch.data.transforms import resize_nearest, resize_shortest_edge

    if len(watch.images) != len(eval_sizes):
        raise SystemExit(f"{label}: scored {len(watch.images)} images, expected {len(eval_sizes)}")
    for rec in watch.images:
        if rec["launches"] != expected:
            raise SystemExit(f"{label}: an image of {rec['input']} launched {rec['launches']}, "
                             f"expected {expected}")
    if watch.fringe[1] or not watch.fringe[0]:
        raise SystemExit(f"{label}: {watch.fringe[1]} of {watch.fringe[0]} pad pixels of the "
                         "model's input are not the rounded pixel mean")
    counted = 0
    for f, hw in zip(sorted(pairs), eval_sizes):
        img, sem = pairs[f]
        _, mapped = resize_shortest_edge(img, sem, 512, 2048)
        counted += int((resize_nearest(mapped.astype(np.int32), hw) != 255).sum())
    nc, conf = watch.confs[-1]
    if int(conf[:nc].sum()) != counted or int(conf.sum()) != sum(h * w for h, w in eval_sizes):
        raise SystemExit(f"{label}: the confusion matrix counts {int(conf[:nc].sum())} labelled "
                         f"pixels, the ground truth has {counted}")
    return ms_by_size(watch.images)


def ms_by_size(images):
    """{padded input 'HxW': [ms of each image]} of watch_eval records."""
    by_size = {}
    for rec in images:
        by_size.setdefault("x".join(map(str, rec["input"])), []).append(rec["ms"])
    return by_size


def metric_bounds(conf, moved, n_moved):
    """How far mIoU, fwIoU and pACC may move from the confusion matrix
    `conf` when n_moved pixels change their prediction, `moved` counting
    each class those predictions left or took: a class's IoU moves by at
    most 2 k / (union - k) for k such pixels."""
    import numpy as np

    n = conf.shape[0] - 1
    c = conf[:n, :n].astype(np.float64)
    gt = c.sum(1)
    union = gt + c.sum(0) - np.diag(c)
    k = np.zeros(n)
    for cls, cnt in moved.items():
        k[cls] += cnt
    valid = gt > 0
    d_iou = np.where(valid, np.minimum(1.0, 2 * k / np.maximum(union - k, 1)), 0.0)
    total = max(gt.sum(), 1)
    return {"mIoU": float(100 * d_iou[valid].sum() / max(valid.sum(), 1)),
            "fwIoU": float(100 * (gt / total * d_iou).sum()), "pACC": float(100 * n_moved / total)}


def eval_phase(dev, smi, counters, aff_opts=(), maskfiner_opts=(), sizes=EVAL_SIZES):
    """Phase 12: train_net.main in this process on the in-memory ADE20K-shaped
    set: EVAL_STEPS steps at batch EVAL_BATCH through TrainLoader with test()
    after every EVAL_PERIOD steps, then --eval-only on the checkpoint; the
    test() images through the kernels and through the plain versions,
    replaying the kernel run's choices; MaskFiner-Mini --eval-only on two
    images; K1, K3 and K9 on the operands of the EVAL_KERNEL_SIZES images'
    forwards.  Returns ({counter: launches of the phase's runs through the
    kernels}, {kernel: {path: record for by_path}})."""
    import os
    import tempfile

    import numpy as np
    import torch
    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.data.transforms import resize_nearest, resize_shortest_edge
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.ops.dispatch import plain_versions

    cfg = PRESETS[EVAL_PRESET]()
    cfg.merge_from_list(list(aff_opts))
    blocks, layers = sum(cfg.MODEL.AFF.DEPTHS), cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS * 3
    per_image = {"local_attn": blocks, "msdetrpc": layers, "knn": 10}
    per_image = {n: per_image.get(n, 0) for n in counters}
    per_step = {"local_attn": blocks, "local_attn_bwd": blocks, "msdetrpc": layers,
                "msdetrpc_bwd": layers, "point_sample": 2, "point_sample_bwd": 1, "lapjv": 1,
                "knn": 10, "point_sample_nearest_rows": 1}
    per_step = {n: per_step.get(n, 0) for n in counters}
    device_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    pairs = eval_dataset(sizes)
    eval_sizes = [h_w for _, h_w in sorted((f, v[0].shape[:2]) for f, v in pairs.items())]
    name = EVAL_NAMES[1]
    phase_launches = {n: 0 for n in counters}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def add(launches):
        for n, v in launches.items():
            phase_launches[n] += v

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="eval_") as tmp, \
            semantic_files(pairs):
        opts = ["DATASETS.TRAIN", f"('{EVAL_NAMES[0]}',)", "DATASETS.TEST", f"('{name}',)",
                "TEST.EVAL_PERIOD", str(EVAL_PERIOD), "SOLVER.IMS_PER_BATCH", str(EVAL_BATCH),
                "OUTPUT_DIR", os.path.join(tmp, "run")] + list(aff_opts)

        # training through the loader, test() every EVAL_PERIOD steps
        reset()
        t0 = time.time()
        with watch_eval(counters) as w_train:
            trainer = train_net.main(["--config", EVAL_PRESET, "--max-iter", str(EVAL_STEPS)]
                                     + device_args + opts)
        t_train = time.time() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        add(launches)
        evals = EVAL_STEPS // EVAL_PERIOD
        want = {n: per_step[n] * EVAL_STEPS + per_image[n] * evals * len(pairs) for n in counters}
        log(f"  {EVAL_PRESET} through train_net.main: {EVAL_STEPS} steps at batch {EVAL_BATCH} "
            f"from TrainLoader, test() after steps {list(range(EVAL_PERIOD, EVAL_STEPS + 1, EVAL_PERIOD))}"
            f" on {len(pairs)} images, {t_train:.1f} s; launches {launches}")
        if launches != want:
            raise SystemExit(f"the train-and-evaluate run launched {launches}, expected {want}")
        with open(os.path.join(tmp, "run", "metrics.jsonl")) as f:
            steps = [json.loads(line) for line in f]
        if [m["step"] for m in steps] != list(range(1, EVAL_STEPS + 1)) or not all(
                np.isfinite(m["total_loss"]) for m in steps):
            raise SystemExit(f"the run logged {[(m['step'], m['total_loss']) for m in steps]}")
        log("  loss per step: " + ", ".join(f"{m['total_loss']:.4f}" for m in steps))
        padded = check_loader_batches(w_train.batches[:EVAL_STEPS])
        log(f"  loader batches: {len(w_train.batches)} taken, shapes and dtypes as the mapper "
            f"gives them; {padded} of {EVAL_STEPS * EVAL_BATCH} samples padded (image 128, "
            "labels 255); labels = the classes of each map")
        in_loop = trainer.results
        n_train = len(w_train.images)
        w_train.images = w_train.images[n_train // 2:]       # the test() after the last step
        check_eval_run("in-loop test()", w_train, pairs, per_image, eval_sizes)
        del trainer

        # --eval-only on the last checkpoint, timed
        reset()
        by_route = getattr(counters.get("knn"), "launches_by_route", {})
        routes_before = dict(by_route)
        t0 = time.time()
        with watch_eval(counters) as w_only:
            evaluated = train_net.main(["--config", EVAL_PRESET, "--eval-only", "--resume"]
                                       + device_args + opts)
        t_only = time.time() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        add(launches)
        by_size = check_eval_run("--eval-only", w_only, pairs, per_image, eval_sizes)
        if evaluated.results != in_loop:
            raise SystemExit(f"--eval-only gave {evaluated.results[name]}, the test() after step "
                             f"{EVAL_STEPS} {in_loop[name]}")
        k_ms = sum(r["ms"] for r in w_only.images)
        log(f"  --eval-only on the step-{EVAL_STEPS} checkpoint equals the in-loop test(): "
            + ", ".join(f"{k} {v:.4f}" for k, v in in_loop[name].items() if not k.startswith("IoU")))
        log(f"  test() through the kernels: {len(pairs)} images, {k_ms:.1f} ms on the model path "
            f"({len(pairs) / k_ms * 1e3:.2f} images/s), {t_only:.1f} s for the command with its "
            f"build and mapping; ms per image by padded input: "
            + ", ".join(f"{k} {statistics.median(v):.1f} (x{len(v)})" for k, v in by_size.items())
            + f" ({smi})")
        log("  knn launches by route in --eval-only: "
            f"{ {r: n - routes_before[r] for r, n in by_route.items()} }")
        log(f"  pad fringe of the model's input: {w_only.fringe[0]} pixels, all "
            f"{np.round(cfg.MODEL.PIXEL_MEAN).astype(int).tolist()}")

        # the same images through the plain versions, replaying the kernel run's choices
        book = {}
        with watch_eval(counters, keep=True) as w_k, same_choices(book, record=True):
            k_results = evaluated.test()
        with watch_eval(counters, keep=True) as w_p, same_choices(book, record=False), \
                plain_versions():
            p_results = evaluated.test()
        same_choices.check("test() plain replay", book)
        del book
        moved, tied_total, worst = {}, 0, 0.0
        for rk, rp in zip(w_k.images, w_p.images):
            sk, sp = rk["scores"], rp["scores"]
            scale = sp.abs().max().item()
            err = (sk - sp).abs().max().item()
            worst = max(worst, err / scale)
            if err > FORWARD_RTOL * scale:
                raise SystemExit(f"test() scores of a {rk['input']} image: kernels and plain "
                                 f"versions disagree by {err} (max |ref| {scale})")
            top2 = sp.topk(2, dim=0).values
            tied = (top2[0] - top2[1]) <= FORWARD_RTOL * scale
            pk, pp = sk.argmax(0), sp.argmax(0)
            diff = pk != pp
            if (diff & ~tied).any():
                raise SystemExit(f"test() predictions of a {rk['input']} image differ at "
                                 f"{int((diff & ~tied).sum())} pixels whose top two scores are "
                                 "apart by more than the tolerance")
            tied_total += int(tied.sum())
            for c in torch.cat([pk[diff], pp[diff]]).tolist():
                moved[c] = moved.get(c, 0) + 1
            rk["scores"] = rp["scores"] = None
        n_moved = sum(moved.values()) // 2
        bounds = metric_bounds(w_k.confs[-1][1], moved, n_moved)
        deltas = {m: abs(k_results[name][m] - p_results[name][m]) for m in bounds}
        log(f"  plain replay: class scores within {worst:.3e} of max |ref| (FORWARD_RTOL "
            f"{FORWARD_RTOL}); {tied_total} pixels near-tied, {n_moved} predictions differ; "
            f"metric differences {deltas} (bounds {bounds})")
        if any(deltas[m] > bounds[m] for m in bounds) or (not n_moved and k_results != p_results):
            raise SystemExit(f"test() metrics: kernels {k_results[name]}, plain {p_results[name]}")
        evaluated.cfg.defrost()        # train_net froze it
        evaluated.cfg.TEST.EXPECTED_RESULTS = [[name, m, k_results[name][m], bounds[m]]
                                               for m in bounds]
        evaluated.verify_results(p_results)
        evaluated.cfg.TEST.EXPECTED_RESULTS = []
        p_ms = sum(r["ms"] for r in w_p.images)
        by_size_p = ms_by_size(w_p.images)
        log(f"  test() through the plain versions (replaying): {p_ms:.1f} ms "
            f"({len(pairs) / p_ms * 1e3:.2f} images/s); ms per image by padded input: "
            + ", ".join(f"{k} {statistics.median(v):.1f} (x{len(v)})" for k, v in by_size_p.items())
            + f" ({smi})")
        for f, hw in zip(sorted(pairs), eval_sizes):
            if hw in ((300, 400), (768, 1024)):
                img, sem = pairs[f]
                _, mapped = resize_shortest_edge(img, sem, 512, 2048)
                back = resize_nearest(mapped, hw)
                log(f"  ground-truth round trip {hw} -> {mapped.shape} -> {hw}: "
                    f"{int((back != sem).sum())} of {sem.size} pixels changed")
        # K1, K3 and K9 on the operands of the widest test images' forwards
        paths = {}
        for f, hw in zip(sorted(pairs), eval_sizes):
            if hw not in EVAL_KERNEL_SIZES or dev.type != "cuda":
                continue
            img = evaluated._pad_eval_image(resize_shortest_edge(pairs[f][0], None, 512, 2048)[0])
            ops = path_forward_operands(evaluated.model.eval(), torch.from_numpy(img)[None].to(dev))
            label = "eval_{}x{}".format(*img.shape[:2])
            levels = sorted({tuple(c[3]) for c in ops["msdetrpc"]})
            log(f"  {label}: the forward's decoder levels {levels}, first stage "
                f"{ops['local_attn'][0][0].shape[2]} tokens")
            for name, check in (("local_attn", check_local_attn_calls), ("msdetrpc", check_msdetrpc),
                                ("knn", check_knn)):
                paths.setdefault(name, {})[label] = check(label, ops[name])
            del ops

            def scores():
                with torch.no_grad():
                    evaluated._padded_scores(img)
                torch.cuda.synchronize()
            scores()
            walls = []
            for _ in range(3):
                t0 = time.time()
                scores()
                walls.append((time.time() - t0) * 1e3)
            busy, rows = device_busy(scores, runs=2)
            wall = statistics.median(walls)
            log(f"  {label}: a test image's forward and scores {wall:.1f} ms, device busy "
                f"{busy:.1f} ms in {rows:.0f} rows (idle {1 - busy / wall:.0%}) ({smi})")
        del evaluated, w_k, w_p
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # MaskFiner-Mini --eval-only on two of the images
        mf_cfg = PRESETS[MASKFINER]()
        mf_cfg.merge_from_list(list(maskfiner_opts))
        mf_expected = {n: maskfiner_launches(mf_cfg).get(n, 0) for n in counters}
        reset()
        with watch_eval(counters) as w_mf:
            mf = train_net.main(["--config", MASKFINER, "--eval-only"] + device_args + [
                "DATASETS.TEST", f"('{EVAL_NAMES[2]}',)", "OUTPUT_DIR", os.path.join(tmp, "mf")]
                + list(maskfiner_opts))
        add({n: fn.launches for n, fn in counters.items()})
        check_eval_run(f"{MASKFINER} --eval-only", w_mf, dict(sorted(pairs.items())[:2]),
                       mf_expected, eval_sizes[:2])
        log(f"  {MASKFINER} --eval-only on {len(w_mf.images)} images: launches per image "
            f"{mf_expected}; ms per image " + ", ".join(
                f"{r['input']} {r['ms']:.1f}" for r in w_mf.images)
            + f"; mIoU {mf.results[EVAL_NAMES[2]]['mIoU']:.4f} ({smi})")
        del mf
    return phase_launches, paths


# the panoptic and instance phase (14): Cityscapes-shaped image / panoptic
# pairs -- (height, width) of each, the first three at the published test
# size -- and COCO-shaped images with instance annotations, made from a
# numpy seed
PAN_PRESET, INST_PRESET = "aff_mini_cityscapes_panoptic", "aff_mini_coco_instance"
PAN_SIZES = ((1024, 2048), (1024, 2048), (1024, 2048), (512, 1024), (768, 1536))
PAN_STEPS, PAN_BATCH = 3, 4
INST_SIZES = ((480, 640), (427, 640), (640, 480), (480, 640), (612, 612), (360, 640))
INST_STEPS, INST_BATCH = 2, 2
PAN_NAMES = ("smoke_cityscapes_panoptic_train", "smoke_cityscapes_panoptic_val")
INST_NAMES = ("smoke_coco_instance_train", "smoke_coco_instance_val")
CITYSCAPES_THINGS = tuple(range(11, 19))
# a second panoptic evaluation beside the preset's 0.8 / 0.8: (object mask,
# overlap) thresholds under which the model at its seeded initial weights
# keeps queries (their class scores are ~0.1)
LOW_THRESHOLDS = (0.0, 0.5)
PAN_OWN = "smoke_cityscapes_panoptic_own"
INST_OWN = "smoke_coco_instance_own"
# the post-processing held on the card against the CPU on structured
# outputs: (label, classes, thing classes, (h, w)); queries as the presets
POSTPROCESS_CASES = (("cityscapes", 19, CITYSCAPES_THINGS, (1024, 2048)),
                     ("coco", 80, tuple(range(80)), (480, 640)))


def smooth_image(rng, h, w):
    """(h, w, 3) uint8: 16-pixel blocks of random colour plus noise."""
    import numpy as np

    coarse = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float64)
    img = coarse.repeat(16, 0).repeat(16, 1)[:h, :w] + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def cityscapes_panoptic_dataset(sizes=PAN_SIZES, seed=SEED):
    """[(dataset dict, image, panoptic ids)]: stuff in 64-pixel blocks of
    train ids 0-10 (segment id = class + 1), 6-16 thing instances (ellipses
    of classes 11-18, ids class * 1000 + k, past 255), the first of them
    crowd, and a void band (id 0) along the bottom, as Cityscapes' ego
    vehicle."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i, (h, w) in enumerate(sizes):
        img = smooth_image(rng, h, w)
        stuff = rng.integers(0, 11, (h // 64 + 1, w // 64 + 1)).repeat(64, 0).repeat(64, 1)[:h, :w]
        pan = stuff.astype(np.int64) + 1
        segs = [{"id": int(c) + 1, "category_id": int(c), "iscrowd": 0} for c in np.unique(stuff)]
        yy, xx = np.ogrid[:h, :w]
        for k in range(int(rng.integers(6, 17))):
            c = int(rng.choice(CITYSCAPES_THINGS))
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry, rx = rng.uniform(h / 40, h / 6), rng.uniform(w / 60, w / 8)
            pan[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = c * 1000 + k
            segs.append({"id": c * 1000 + k, "category_id": c, "iscrowd": int(k == 0)})
        pan[h - h // 12:] = 0
        present = set(np.unique(pan).tolist())
        segs = [s for s in segs if s["id"] in present]
        name = f"smoke_cs/{i:02d}_{h}x{w}"
        out.append(({"file_name": name + ".png", "pan_seg_file_name": name + "_pan.png",
                     "image_id": name, "height": h, "width": w, "segments_info": segs}, img, pan))
    return out


def compressed_rle(counts):
    """pycocotools' compressed RLE string of run lengths."""
    out = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | (0x20 if more else 0)) + 48))
    return "".join(out)


def coco_instance_dataset(sizes=INST_SIZES, seed=SEED):
    """[(dataset dict, image)]: 5-20 instances an image of COCO's 80
    classes as polygons (star-shaped, one or two parts), uncompressed RLE
    and compressed RLE, and one crowd instance (RLE)."""
    import numpy as np
    from autofocusformermod_torch.evaluation.instance_evaluation import rle_encode

    rng = np.random.default_rng(seed)
    out = []
    for i, (h, w) in enumerate(sizes):
        img = smooth_image(rng, h, w)
        yy, xx = np.ogrid[:h, :w]
        annos = []
        for k in range(int(rng.integers(5, 21))):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(8, min(h, w) / 3)
            kind = k % 4
            if kind < 2:
                parts = []
                for _ in range(1 + kind):
                    n = int(rng.integers(5, 40))
                    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
                    rad = r * rng.uniform(0.4, 1.0, n)
                    parts.append([float(v) for v in np.stack(
                        [cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1).reshape(-1)])
                    cx += r
                seg = parts
            else:
                m = ((yy - cy) / r) ** 2 + ((xx - cx) / (0.6 * r)) ** 2 <= 1
                counts = [int(c) for c in rle_encode(m)["counts"]]
                seg = {"size": [h, w], "counts": counts if kind == 2 else compressed_rle(counts)}
            annos.append({"category_id": int(rng.integers(0, 80)), "iscrowd": int(k == 4),
                          "segmentation": seg})
        name = f"smoke_coco/{i:02d}_{h}x{w}.jpg"
        out.append(({"file_name": name, "image_id": 1000 + i, "height": h, "width": w,
                     "annotations": annos}, img))
    return out


class watch_predict:
    """Within the block: every test() image's model pass (Trainer.
    _predict_image) with its padded input size, its time on the card and
    the launches of `counters` in it, and the post-processing's time
    (panoptic or instance inference, as the trainer calls it)."""

    def __init__(self, counters):
        self.counters, self.images, self.post_ms = counters, [], []

    def __enter__(self):
        from autofocusformermod_torch.engine import train

        self.saved = [(train.Trainer, "_predict_image", train.Trainer._predict_image),
                      (train, "panoptic_inference", train.panoptic_inference),
                      (train, "instance_inference", train.instance_inference)]
        (_, _, predict), (_, _, pan), (_, _, inst) = self.saved
        watch = self

        def predict_(self, image):
            out, ms, launches = counted_call(watch.counters, lambda: predict(self, image))
            pad = -(-image.shape[0] // 32) * 32, -(-image.shape[1] // 32) * 32
            watch.images.append({"input": pad, "ms": ms, "launches": launches})
            return out

        def post(fn):
            def wrapped(*a, **k):
                out, ms, _ = counted_call({}, lambda: fn(*a, **k))
                watch.post_ms.append(ms)
                return out
            return wrapped

        train.Trainer._predict_image = predict_
        train.panoptic_inference, train.instance_inference = post(pan), post(inst)
        return self

    def __exit__(self, *exc):
        for owner, name, real in self.saved:
            setattr(owner, name, real)


def hold_panoptic(label, trainer, image, thing_ids, thresholds):
    """One test image's forward through the kernels and through the plain
    versions (replaying the kernel run's choices), held to FORWARD_RTOL, and
    the panoptic inference of both at each (object mask, overlap) threshold
    pair: the maps equal but at pixels whose two best prob masks lie within
    twice the prob masks' difference, or whose winning mask logit within
    twice the logits' (near-tied), and the segments equal where no pixel
    differs."""
    import torch
    from autofocusformermod_torch.models.inference import panoptic_inference
    from autofocusformermod_torch.ops.dispatch import plain_versions

    nc = trainer.cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    book = {}
    with trainer._eval_mode():
        with same_choices(book, record=True):
            lk, mk = trainer._predict_image(image)
        with same_choices(book, record=False), plain_versions():
            lp, mp = trainer._predict_image(image)
    errs = {}
    for key, a, r in (("logits", lk, lp), ("masks", mk, mp)):
        scale = max(r.abs().max().item(), 1.0)
        errs[key] = (a - r).abs().max().item()
        if not torch.isfinite(a).all() or errs[key] > FORWARD_RTOL * scale:
            raise SystemExit(f"{label} {key}: kernels and plain versions disagree by {errs[key]} "
                             f"(max |ref| {scale})")
    same_choices.check(label, book)
    log(f"  {label}: logits within {errs['logits']:.3e}, masks within {errs['masks']:.3e}")
    for object_mask, overlap in thresholds:
        pan_k, info_k = panoptic_inference(lk, mk, thing_ids, nc, object_mask, overlap)
        pan_p, info_p = panoptic_inference(lp, mp, thing_ids, nc, object_mask, overlap)

        def prob_masks(logits, masks):
            probs = torch.softmax(logits, -1)
            keep = (probs.argmax(1) != nc) & (probs.max(1).values > object_mask)
            return torch.where(keep[:, None, None],
                               probs.max(1).values[:, None, None] * torch.sigmoid(masks), -1.0)

        pm_p = prob_masks(lp, mp)
        pm_err = (prob_masks(lk, mk) - pm_p).abs().max().item()
        top2 = pm_p.topk(2, dim=0)
        win_logit = mp.gather(0, top2.indices[:1])[0]
        tied = (((top2.values[0] - top2.values[1]) <= 2 * pm_err)
                | (win_logit.abs() <= 2 * errs["masks"])) & (top2.values[0] >= 0)
        del pm_p, top2, win_logit
        differ = pan_k != pan_p
        off = int((differ & ~tied).sum())
        n_tied, n_differ = int(tied.sum()), int(differ.sum())
        log(f"    thresholds {object_mask} / {overlap}: {len(info_k)} segments (plain "
            f"{len(info_p)}), {n_differ} of {differ.numel()} pixels differ, {n_tied} near-tied")
        if off or (not n_differ and info_k != info_p):
            raise SystemExit(f"{label}: the panoptic maps differ at {off} pixels that are not "
                             f"near-tied, or the segments differ ({info_k} / {info_p})")


def hold_instance(label, trainer, image, out_hw, is_thing):
    """One COCO-sized test image's forward through the kernels and through
    the plain versions (replaying the kernel run's choices), held to
    FORWARD_RTOL, and the instance inference of both at the original size:
    the (query, class) pairs equal but where a class probability lies
    within twice the two runs' difference of the cut, the scores of the
    common pairs within FORWARD_RTOL, their masks equal but at pixels whose
    |logit| lies within FORWARD_RTOL of the largest."""
    import torch
    from autofocusformermod_torch.models.inference import instance_inference, sem_seg_postprocess
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.gather import topk_indices

    cfg = trainer.cfg
    nc, topk = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, cfg.TEST.DETECTIONS_PER_IMAGE
    book = {}
    with trainer._eval_mode():
        with same_choices(book, record=True):
            lk, mk = trainer._predict_image(image)
        with same_choices(book, record=False), plain_versions():
            lp, mp = trainer._predict_image(image)
        mk = sem_seg_postprocess(mk, mk.shape[-2:], out_hw)
        mp = sem_seg_postprocess(mp, mp.shape[-2:], out_hw)
    for key, a, r in (("logits", lk, lp), ("masks", mk, mp)):
        scale = max(r.abs().max().item(), 1.0)
        e = (a - r).abs().max().item()
        if not torch.isfinite(a).all() or e > FORWARD_RTOL * scale:
            raise SystemExit(f"{label} {key}: kernels and plain versions disagree by {e}")
    same_choices.check(label, book)
    panoptic_on = cfg.MODEL.MASK_FORMER.TEST.PANOPTIC_ON
    ik = instance_inference(lk, mk, is_thing, nc, topk=topk, panoptic_on=panoptic_on)
    ip = instance_inference(lp, mp, is_thing, nc, topk=topk, panoptic_on=panoptic_on)
    fk = torch.softmax(lk, -1)[:, :-1].reshape(-1)
    fp = torch.softmax(lp, -1)[:, :-1].reshape(-1)
    sel_k, sel_p = topk_indices(fk[None], topk)[0].tolist(), topk_indices(fp[None], topk)[0].tolist()
    cut, tol = fp.sort(descending=True).values[topk - 1].item(), 2 * (fk - fp).abs().max().item()
    moved = set(sel_k) ^ set(sel_p)
    if any(abs(fp[i].item() - cut) > tol for i in moved):
        raise SystemExit(f"{label}: the top-{topk} pairs differ away from the cut: {moved}")
    tol_logit = FORWARD_RTOL * mp.abs().max().item()
    worst, mask_off = 0.0, 0
    for pos_k, i in enumerate(sel_k):
        if i not in sel_p:
            continue
        pos_p = sel_p.index(i)
        worst = max(worst, abs(ik["scores"][pos_k].item() - ip["scores"][pos_p].item()))
        q = i // nc
        mask_off += int(((ik["masks"][pos_k] != ip["masks"][pos_p])
                         & (mp[q].abs() > tol_logit)).sum())
    log(f"  {label}: top-{topk} pairs {len(set(sel_k) & set(sel_p))} shared, {len(moved)} moved "
        f"at the cut; scores within {worst:.3e}; mask pixels differing away from |logit| "
        f"<= {tol_logit:.3e}: {mask_off}")
    if worst > FORWARD_RTOL or mask_off:
        raise SystemExit(f"{label}: instance scores differ by {worst} or masks at {mask_off} "
                         "pixels")
    return {"pairs_moved": len(moved), "score_err": worst}


def structured_outputs(seed, q, nc, things, hw):
    """(class logits (q, nc+1), mask logits (q, h, w)), float32 numpy, of one
    image with the post-processing's cases built in, on a grid of 16 x 32
    blocks.  Queries 0-59 own blocks (mask logit 6 +- 0.5 there, -6
    elsewhere) with confident classes (score >= 0.98): the odd ones thing
    classes, the even ones four stuff classes, so stuff queries share
    classes and merge; 60-69 own blocks at scores 0.65-0.75 (kept only
    under a low object threshold); 70-79 own blocks but vote no-object;
    80-84 are confident with a mask of logit 1.5 +- 0.5 over 12 blocks, of
    which they win the 2 (80, 81) or 5 (82-84) no one else holds: overlap
    1/6 or 5/12, filtered at 0.8, the second kept at 0.3; 85-94 copy
    queries 0-9 exactly (ties: the lower index wins); 95's mask is empty;
    96-99 are confident and own nothing, 96 with the best score, so it
    wins the 24 blocks no one holds (void: its mask is empty there).  The
    top two block rows have mask logit 40 (sigmoid 1.0) in queries 0-9 and
    85-94: exact ties of the best of their scores, whose query wins the
    band; the other nine of 0-9 win under a tenth of their masks.  Scores of distinct
    queries lie >= 5e-3 apart in logit, so two prob masks are equal or far
    apart."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    things = list(things)
    stuff = [c for c in range(nc) if c not in set(things)][:4]
    off = 0.005 * rng.permutation(q)
    off[96] = 0.6
    labels = [int(rng.choice(stuff if j % 2 == 0 and stuff else things)) for j in range(q)]
    logits = np.zeros((q, nc + 1), np.float64)
    sure, unsure = np.log(49 * nc), np.log(1.86 * nc)
    for j in range(q):
        if 70 <= j < 80:
            logits[j, nc] = 12 + off[j]
        else:
            logits[j, labels[j]] = (unsure if 60 <= j < 70 else sure) + off[j]
    row = np.minimum(np.arange(h) * 16 // h, 15)
    col = np.minimum(np.arange(w) * 32 // w, 31)
    rows = [np.flatnonzero(row == r) for r in range(16)]
    cols = [np.flatnonzero(col == c) for c in range(32)]
    masks = np.full((q, h, w), -6.0, np.float32)

    def put(j, b, value):
        ys, xs = rows[b // 32], cols[b % 32]
        masks[j, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = value + 0.5 * rng.uniform(
            -1, 1, (len(ys), len(xs)))

    blocks = 64 + rng.permutation(16 * 32 - 64)       # below the band's two block rows
    free, taken = blocks[:43], blocks[43:]           # 19 for 80-84, 24 void
    owner = {int(b): i % 80 for i, b in enumerate(taken)}
    for b, j in owner.items():
        put(j, b, 6.0)
    confident = [b for b, j in owner.items() if j < 60]
    won = iter(free)
    for j, n_won in ((80, 2), (81, 2), (82, 5), (83, 5), (84, 5)):
        for b in list(rng.choice(confident, 12 - n_won, replace=False)) + [
                next(won) for _ in range(n_won)]:
            put(j, int(b), 1.5)
    masks[:10, row < 2] = 40.0
    masks[85:95], logits[85:95] = masks[:10], logits[:10]
    masks[95] = -6.0
    return logits.astype(np.float32), masks


def own_panoptic_gt(pan, info, nc):
    """Panoptic ground truth (ids (h, w) int64, segments_info) made from a
    prediction: each segment kept (id x 1000 + 7), the right quarter of the
    first segment and of the first thing segment (by column) made a
    segment of the next class, the bottom 40 rows void; so PQ counts
    matches of things and stuff but cannot be 100."""
    import numpy as np

    gt = np.where(pan > 0, pan.astype(np.int64) * 1000 + 7, 0)
    segs = [{"id": g["id"] * 1000 + 7, "category_id": g["category_id"], "iscrowd": 0}
            for g in info]
    split = {0} | {next((k for k, g in enumerate(info) if g["isthing"]), 0)}
    for k in sorted(split) if segs else ():
        part = gt == segs[k]["id"]
        cols = np.nonzero(part)[1]
        part &= np.arange(gt.shape[1])[None, :] > np.percentile(cols, 75)
        gt[part] = 999_000 + k
        segs.append({"id": 999_000 + k, "iscrowd": 0,
                     "category_id": (segs[k]["category_id"] + 1) % nc})
    gt[-40:] = 0
    present = set(np.unique(gt).tolist())
    return gt, [g for g in segs if g["id"] in present]


def hold_postprocess(label, dev, nc, things, hw, thresholds, topk):
    """panoptic_inference and instance_inference on the card against the
    CPU on the same structured outputs (structured_outputs at q 100):
    panoptic maps and segments_info equal at each (object mask, overlap)
    threshold pair, with thing segments, merged stuff queries, queries
    filtered by overlap and pixels of exactly tied prob masks required;
    PQ of the card's map against ground truth made from it neither 0 nor
    100 for things and stuff; the instance pairs, labels, masks and
    `valid` equal and scores within FORWARD_RTOL, with panoptic_on off and
    on; the card's time of each call."""
    import numpy as np
    import torch
    from autofocusformermod_torch.evaluation.panoptic_evaluation import PanopticEvaluator
    from autofocusformermod_torch.models.inference import (instance_inference,
                                                           panoptic_inference,
                                                           panoptic_inference_arrays,
                                                           thing_lookup)

    logits, masks = structured_outputs(SEED, 100, nc, things, hw)
    lc, mc = torch.from_numpy(logits), torch.from_numpy(masks)
    ld, md = lc.to(dev), mc.to(dev)
    is_thing = thing_lookup(things, nc)
    ms = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        ms[key] = (time.time() - t0) * 1e3
        return out

    for object_mask, overlap in thresholds:
        key = f"panoptic {object_mask}/{overlap}"
        pan_d, info_d = timed(key, lambda: panoptic_inference(ld, md, things, nc, object_mask,
                                                              overlap))
        pan_c, info_c = panoptic_inference(lc, mc, things, nc, object_mask, overlap)
        _, is_new, seg_id, _, isthing = panoptic_inference_arrays(lc, mc, is_thing, nc,
                                                                  object_mask, overlap)
        probs = torch.softmax(ld, -1)
        keep = (probs.argmax(1) != nc) & (probs.max(1).values > object_mask)
        prob_masks = torch.where(keep[:, None, None],
                                 probs.max(1).values[:, None, None] * torch.sigmoid(md), -1.0)
        top2 = prob_masks.topk(2, dim=0).values
        tied = int(((top2[0] == top2[1]) & (top2[0] >= 0)).sum())
        keep = keep.cpu()
        del prob_masks, top2
        valid = seg_id > 0
        counts = {"segments": len(info_c), "thing": sum(s["isthing"] for s in info_c),
                  "stuff merged": int((valid & ~is_new & ~isthing).sum()),
                  "kept without a segment": int((keep & ~valid).sum()),
                  "tied pixels": tied}
        differ = int((pan_d.cpu() != pan_c).sum())
        log(f"  {label} post-processing {hw}, thresholds {object_mask} / {overlap}: "
            + ", ".join(f"{k} {v}" for k, v in counts.items())
            + f"; card against CPU: {differ} pixels differ, segments_info "
            + ("equal" if info_d == info_c else "differs") + f"; {ms[key]:.1f} ms on the card")
        if differ or info_d != info_c or min(counts.values()) < 1 or counts["thing"] < 10:
            raise SystemExit(f"{label}: the card's panoptic inference differs from the CPU's "
                             f"({differ} pixels; {info_d} / {info_c}) or the case lacks a part "
                             f"({counts})")
        gt, segs = own_panoptic_gt(pan_c.numpy(), info_c, nc)
        ev = PanopticEvaluator(set(things), nc)
        ev.process(pan_d.cpu().numpy(), info_d, gt, segs)
        pq = ev.evaluate()
        log(f"    PQ of the card's map against ground truth made from it: "
            + ", ".join(f"{k} {v:.4f}" for k, v in pq.items()))
        if not all(0 < pq[k] < 100 for k in ("PQ", "PQ_th", "PQ_st")):
            raise SystemExit(f"{label}: PQ {pq}")
    for panoptic_on in (False, True):
        key = f"instance panoptic_on={panoptic_on}"
        got = timed(key, lambda: instance_inference(ld, md, is_thing, nc, topk=topk,
                                                    panoptic_on=panoptic_on))
        want = instance_inference(lc, mc, is_thing, nc, topk=topk, panoptic_on=panoptic_on)
        equal = {k: bool(torch.equal(got[k].cpu(), want[k])) for k in ("labels", "masks", "valid")}
        err = (got["scores"].cpu() - want["scores"]).abs().max().item()
        flat = torch.softmax(lc, -1)[:, :-1].reshape(-1)
        cut = flat.sort(descending=True).values[topk - 1]
        at_cut = int((flat == cut).sum())
        log(f"  {label} instance inference {hw}, top-{topk} of {flat.numel()}, panoptic_on "
            f"{panoptic_on}: {at_cut} pairs tied at the cut, {int(want['valid'].sum())} valid; "
            f"card against CPU: {equal}, scores within {err:.3e}; {ms[key]:.1f} ms on the card")
        if not all(equal.values()) or err > FORWARD_RTOL or at_cut < 2:
            raise SystemExit(f"{label}: the card's instance inference differs from the CPU's")


def hold_step_operands(label, model, cfg, batch, gen, paths):
    """K2, K4, K10 (each route the masks give), K12 and K13 on the operands
    of one real step of `model` on `batch`, each against its plain version;
    records into paths[kernel][label]."""
    import torch
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.ops.point_sample import point_sample_nearest_rows

    ops = path_maskfiner_step_operands(model, cfg, batch,
                                       device_draw(torch.Generator(device=batch["image"].device)
                                                   .manual_seed(SEED)))
    paths.setdefault("local_attn_bwd", {})[label] = check_local_attn_bwd_calls(
        label, ops.pop("local_attn_bwd"))
    paths.setdefault("msdetrpc_bwd", {})[label] = msdetrpc_bwd_calls(label, ops.pop("msdetrpc_bwd"),
                                                                    gen)
    torch.cuda.empty_cache()
    groups = ops.pop("point_sample")
    paths.setdefault("point_sample", {})[label] = summed({
        "x".join(map(str, g["logits"][0].shape[-2:])): point_sample_calls(
            f"{label} {tuple(g['logits'][0].shape[-2:])}", g, gen) for g in groups.values()})
    del groups
    torch.cuda.empty_cache()
    rows = ops.pop("point_sample_nearest_rows")
    if len(rows) != 1 or ops.pop("point_sample_nearest"):
        raise SystemExit(f"{label}: the ranking read {len(rows)} times through the stratified "
                         "route and otherwise through the i.i.d. one; expected once, stratified")
    paths.setdefault("point_sample_nearest_rows", {})[label] = hold_nearest(
        f"{label} w{rows[0][0].shape[-1]}", point_sample_nearest_rows, rows[0][0], rows[0][1:])
    del rows
    cost = ops.pop("lapjv")[0][0]
    targets = batch["valid"].sum(1).tolist()
    log(f"  {label}: the matcher's costs {tuple(cost.shape)}, real targets per image {targets}")
    paths.setdefault("lapjv", {})[label] = lapjv_costs(label, cost)
    del ops, cost
    torch.cuda.empty_cache()


def hold_forward_operands(label, model, image, paths):
    """K1, K3 and K9 on every call of one forward of `image` (1, H, W, 3),
    each against its plain version; records into paths[kernel][label]."""
    import torch

    ops = path_forward_operands(model.eval(), image)
    levels = sorted({tuple(c[3]) for c in ops["msdetrpc"]})
    log(f"  {label}: first stage {ops['local_attn'][0][0].shape[2]} tokens, decoder levels "
        f"{levels}")
    for name, check in (("local_attn", check_local_attn_calls), ("msdetrpc", check_msdetrpc),
                        ("knn", check_knn)):
        paths.setdefault(name, {})[label] = check(label, ops[name])
    del ops
    torch.cuda.empty_cache()


def panoptic_instance_phase(dev, smi, gen, counters, pan_opts=(), inst_opts=(),
                            pan_sizes=PAN_SIZES, inst_sizes=INST_SIZES):
    """Phase 14: the Cityscapes-panoptic and COCO-instance AFF-Mini presets
    through train_net.main in this process, on in-memory seeded data:
    PAN_STEPS steps at batch PAN_BATCH on 512x1024 crops from the panoptic
    mapper, then test() (PQ) over the test set at 1024x2048, --eval-only
    on the checkpoint (equal to it), and test() at the seeded initial
    weights and LOW_THRESHOLDS against ground truth made from their own
    predictions, which PQ must neither miss nor match fully; INST_STEPS
    LSJ steps at 1024x1024, batch INST_BATCH, then test() (COCO mask AP)
    at 800x1333, and test() against ground truth made from the trained
    model's own detections, whose AP must lie strictly between 0 and 100.
    Every test image's launches against the forward's; the steps' and
    test()'s time, images/s and peak memory.  The panoptic and instance
    post-processing on the card against the CPU on structured outputs
    (hold_postprocess); a 1024x2048 and a COCO-sized test image through
    the kernels and the plain versions (hold_panoptic, hold_instance); K1,
    K3 and K9 on the operands of the 1024x2048 forward (131,072
    first-stage tokens), K2, K4, K10, K12 and K13 on those of a real step
    of each preset, and that step replayed through the plain versions
    (replay_step).  Returns ({counter: launches of the train_net runs},
    {kernel: {path: record for by_path}})."""
    import copy
    import os
    import tempfile

    import torch
    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.data.loader import device_batch, eval_loader
    from autofocusformermod_torch.data.mapper_panoptic_instance import (
        MaskFormerInstanceDatasetMapper)
    from autofocusformermod_torch.data.transforms import resize_shortest_edge
    from autofocusformermod_torch.evaluation.instance_evaluation import rle_encode
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.inference import (instance_inference, panoptic_inference,
                                                           sem_seg_postprocess, thing_lookup)
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.ops.point_sample import point_sample_backward, point_sample_bilinear

    cuda = dev.type == "cuda"
    device_args = [] if cuda else ["--device", "cpu"]
    phase_launches, paths = {n: 0 for n in counters}, {}
    routed = [fn for fn in (point_sample_bilinear, point_sample_backward, counters.get("lapjv"),
                            counters.get("knn")) if hasattr(fn, "launches_by_route")]

    def reset():
        for fn in counters.values():
            fn.launches = 0
        return [dict(fn.launches_by_route) for fn in routed]

    def take(before):
        got = {n: fn.launches for n, fn in counters.items()}
        for n, v in got.items():
            phase_launches[n] += v
        return got, {fn.__name__: {r: fn.launches_by_route[r] - b[r] for r in b}
                     for fn, b in zip(routed, before)}

    def per_image(cfg):
        blocks, layers = sum(cfg.MODEL.AFF.DEPTHS), cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS * 3
        return {n: {"local_attn": blocks, "msdetrpc": layers, "knn": 10}.get(n, 0) for n in counters}

    def per_step(cfg):
        blocks, layers = sum(cfg.MODEL.AFF.DEPTHS), cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS * 3
        return {n: {"local_attn": blocks, "local_attn_bwd": blocks, "msdetrpc": layers,
                    "msdetrpc_bwd": layers, "point_sample": 2, "point_sample_bwd": 1, "lapjv": 1,
                    "knn": 10, "point_sample_nearest_rows": 1}.get(n, 0) for n in counters}

    def report(label, trainer, watch, steps, name, n_images, t_run):
        with open(os.path.join(trainer.cfg.OUTPUT_DIR, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        if [m["step"] for m in logged] != list(range(1, steps + 1)) or not all(
                math.isfinite(m["total_loss"]) for m in logged):
            raise SystemExit(f"{label}: the run logged {[(m['step'], m['total_loss']) for m in logged]}")
        want = per_image(trainer.cfg)
        for rec in watch.images:
            if cuda and rec["launches"] != want:
                raise SystemExit(f"{label}: a test image of {rec['input']} launched "
                                 f"{rec['launches']}, expected {want}")
        if len(watch.images) != n_images:
            raise SystemExit(f"{label}: test() scored {len(watch.images)} images, expected "
                             f"{n_images}")
        metrics = trainer.results[name]
        if not all(math.isfinite(v) for v in metrics.values()):
            raise SystemExit(f"{label}: test() gave {metrics}")
        ms = sum(r["ms"] for r in watch.images) + sum(watch.post_ms)
        step_ms = [m["seconds"] * 1e3 for m in logged]
        peak = max(m.get("peak_bytes_in_use", 0) for m in logged) / 2 ** 30
        by_size = ms_by_size(watch.images)
        log(f"  {label}: {steps} steps ({', '.join(f'{t:.0f}' for t in step_ms)} ms; loss "
            + ", ".join(f"{m['total_loss']:.4f}" for m in logged) + f"; peak {peak:.2f} GiB), "
            f"{t_run:.1f} s for the command with its mapping")
        log(f"  {label} test(): " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
            + f"; {n_images} images in {ms:.1f} ms on the model and post-processing "
            f"({n_images / ms * 1e3:.2f} images/s); forward ms by padded input: "
            + ", ".join(f"{k} {statistics.median(v):.1f} (x{len(v)})" for k, v in by_size.items())
            + f"; post-processing {statistics.median(watch.post_ms):.1f} ms an image ({smi})")

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pan_data = cityscapes_panoptic_dataset(pan_sizes)
    inst_data = coco_instance_dataset(inst_sizes)
    images = {d["file_name"]: img for d, img, _ in pan_data}
    images.update({d["file_name"]: img for d, img in inst_data})
    pans = {d["pan_seg_file_name"]: pan for d, _, pan in pan_data}
    pan_dicts, inst_dicts = [d for d, _, _ in pan_data], [d for d, _ in inst_data]
    pan_meta = {"evaluator_type": "cityscapes_panoptic_seg", "ignore_label": 255,
                "thing_dataset_id_to_contiguous_id": {i: i for i in CITYSCAPES_THINGS}}
    inst_meta = {"evaluator_type": "coco_instance",
                 "thing_dataset_id_to_contiguous_id": {i: i for i in range(80)}}
    segs = [len(d["segments_info"]) for d in pan_dicts]
    annos = [len(d["annotations"]) for d in inst_dicts]
    log(f"  data: {len(pan_dicts)} Cityscapes-shaped pairs {[tuple(s) for s in pan_sizes]}, "
        f"{min(segs)}-{max(segs)} segments each; {len(inst_dicts)} COCO-shaped images "
        f"{[tuple(s) for s in inst_sizes]}, {min(annos)}-{max(annos)} annotations each "
        "(polygons, RLE, compressed RLE, crowd)")
    module = "autofocusformermod_torch.data.mapper_panoptic_instance"

    def draw():
        return device_draw(torch.Generator(device=dev).manual_seed(SEED))

    for label, nc, things, hw in POSTPROCESS_CASES:
        hold_postprocess(label, dev, nc, things, hw,
                         ((0.8, 0.8), (0.5, 0.3)) if label == "cityscapes" else (), 100)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="paninst_") as tmp, \
            in_memory_files({PAN_NAMES[0]: (pan_dicts, pan_meta), PAN_NAMES[1]: (pan_dicts, pan_meta),
                             INST_NAMES[0]: (inst_dicts, inst_meta),
                             INST_NAMES[1]: (inst_dicts, inst_meta)},
                            {(module, "read_image"): images, (module, "read_pan_seg"): pans}):
        # ---- Cityscapes panoptic: steps from the panoptic mapper, test() (PQ) at the end
        opts = ["DATASETS.TRAIN", f"('{PAN_NAMES[0]}',)", "DATASETS.TEST", f"('{PAN_NAMES[1]}',)",
                "TEST.EVAL_PERIOD", str(PAN_STEPS), "SOLVER.IMS_PER_BATCH", str(PAN_BATCH),
                "OUTPUT_DIR", os.path.join(tmp, "pan")] + list(pan_opts)
        before = reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with watch_predict(counters) as w:
            trainer = train_net.main(["--config", PAN_PRESET, "--max-iter", str(PAN_STEPS)]
                                     + device_args + opts)
        t_run = time.time() - t0
        launches, by_route = take(before)
        cfg = trainer.cfg
        want = {n: per_step(cfg)[n] * PAN_STEPS + per_image(cfg)[n] * len(pan_dicts)
                for n in counters}
        log(f"  {PAN_PRESET}: launches {launches} (expected {want}); by route {by_route}")
        if cuda and launches != want:
            raise SystemExit(f"{PAN_PRESET}: launched {launches}, expected {want}")
        report(PAN_PRESET, trainer, w, PAN_STEPS, PAN_NAMES[1], len(pan_dicts), t_run)
        if not 0.0 <= trainer.results[PAN_NAMES[1]]["PQ"] <= 100.0:
            raise SystemExit(f"PQ {trainer.results[PAN_NAMES[1]]['PQ']}")
        if cuda and (by_route["point_sample_bilinear"]["shared"] < PAN_STEPS
                     or by_route["point_sample_bilinear"]["direct"] < PAN_STEPS):
            raise SystemExit(f"{PAN_PRESET}: point_sample took {by_route}; the 512x1024 targets "
                             "belong to the direct route, the 128x256 logits to the shared one")
        thing_ids = set(CITYSCAPES_THINGS)
        # --eval-only on the checkpoint equals the in-loop test()
        before = reset()
        with watch_predict(counters) as w:
            evaluated = train_net.main(["--config", PAN_PRESET, "--eval-only", "--resume"]
                                       + device_args + opts)
        take(before)
        if evaluated.results != trainer.results:
            raise SystemExit(f"--eval-only gave {evaluated.results}, the in-loop test() "
                             f"{trainer.results}")
        del evaluated
        # after 3 steps every query votes no-object, so at any threshold the
        # panoptic inference keeps none and PQ is 0.  The preset's model at
        # its seeded initial weights (no query votes no-object there) under
        # the low thresholds, against ground truth made from its own
        # predictions on the test images at the test size (its first
        # segment's right quarter made a segment of another class, a void
        # band at the bottom): a test() whose PQ counts matches
        low_cfg = copy.deepcopy(cfg)
        low_cfg.MODEL.MASK_FORMER.TEST.OBJECT_MASK_THRESHOLD = LOW_THRESHOLDS[0]
        low_cfg.MODEL.MASK_FORMER.TEST.OVERLAP_THRESHOLD = LOW_THRESHOLDS[1]
        low_cfg.OUTPUT_DIR = os.path.join(tmp, "pan_low")
        low = Trainer(low_cfg, dev)
        own = []
        with low._eval_mode():
            for d in pan_dicts:
                if (d["height"], d["width"]) != (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST):
                    continue
                pan, info = panoptic_inference(*low._predict_image(images[d["file_name"]]),
                                               thing_ids, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                               *LOW_THRESHOLDS)
                gt, segs = own_panoptic_gt(pan.cpu().numpy(), info,
                                           cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
                name = d["pan_seg_file_name"][:-4] + "_own.png"
                pans[name] = gt
                own.append({**d, "pan_seg_file_name": name, "segments_info": segs})
        DatasetCatalog.register(PAN_OWN, lambda: [dict(d) for d in own])
        MetadataCatalog.get(PAN_OWN).set(**pan_meta)
        low.cfg.defrost()              # train_net froze it
        low.cfg.DATASETS.TEST = [PAN_OWN]
        before = reset()
        try:
            with watch_predict(counters) as w:
                pq = low.test()[PAN_OWN]
        finally:
            DatasetCatalog.remove(PAN_OWN)
        take(before)
        if cuda and any(r["launches"] != per_image(cfg) for r in w.images):
            raise SystemExit(f"test(): images launched {[r['launches'] for r in w.images]}")
        log(f"  {PAN_PRESET} --eval-only --resume equals the in-loop test(); at the seeded "
            f"initial weights and thresholds {LOW_THRESHOLDS}, against ground truth made from its "
            f"own predictions ({[len(d['segments_info']) for d in own]} segments): "
            + ", ".join(f"{k} {v:.4f}" for k, v in pq.items())
            + f"; post-processing {statistics.median(w.post_ms):.1f} ms an image")
        if not all(math.isfinite(v) for v in pq.values()) or not 0 < pq["PQ"] < 100:
            raise SystemExit(f"test() against its own predictions gave {pq}")
        first = resize_shortest_edge(images[pan_dicts[0]["file_name"]], None,
                                     cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)[0]
        test = cfg.MODEL.MASK_FORMER.TEST
        hold_panoptic(f"{PAN_PRESET} test image {first.shape[:2]}", trainer, first, thing_ids,
                      [(test.OBJECT_MASK_THRESHOLD, test.OVERLAP_THRESHOLD)])
        hold_panoptic(f"{PAN_PRESET} test image {first.shape[:2]}, initial weights", low,
                      first, thing_ids, [LOW_THRESHOLDS])
        padded = torch.from_numpy(trainer._pad_eval_image(first))[None].to(dev)
        if cuda:
            hold_forward_operands("cityscapes_1024x2048", trainer.model, padded, paths)

            def image_pass():
                with trainer._eval_mode():
                    test = cfg.MODEL.MASK_FORMER.TEST
                    panoptic_inference(*trainer._predict_image(first), thing_ids,
                                       cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                       test.OBJECT_MASK_THRESHOLD, test.OVERLAP_THRESHOLD)
                torch.cuda.synchronize()
            image_pass()
            walls = []
            for _ in range(3):
                t0 = time.time()
                image_pass()
                walls.append((time.time() - t0) * 1e3)
            busy, rows = device_busy(image_pass, runs=2)
            wall = statistics.median(walls)
            log(f"  a 1024x2048 test image (forward and panoptic inference): {wall:.1f} ms, "
                f"device busy {busy:.1f} ms in {rows:.0f} rows (idle {1 - busy / wall:.0%}) "
                f"({smi})")
        loader = trainer.build_train_loader()
        try:
            batch = device_batch(next(loader), dev)
        finally:
            loader.close()
        log(f"  a batch of {PAN_PRESET} from the loader: image {tuple(batch['image'].shape)}, "
            f"masks {tuple(batch['masks'].shape)}, targets per image "
            f"{batch['valid'].sum(1).tolist()}")
        if cuda:
            hold_step_operands(f"cityscapes_b{PAN_BATCH}_step", trainer.model, cfg, batch,
                               gen, paths)
            replay_step(PAN_PRESET, trainer.model, cfg, batch, draw)
        del batch
        del trainer, low
        if cuda:
            torch.cuda.empty_cache()

        # ---- COCO instance: LSJ steps, test() (COCO mask AP) at the end
        opts = ["DATASETS.TRAIN", f"('{INST_NAMES[0]}',)", "DATASETS.TEST", f"('{INST_NAMES[1]}',)",
                "TEST.EVAL_PERIOD", str(INST_STEPS), "SOLVER.IMS_PER_BATCH", str(INST_BATCH),
                "OUTPUT_DIR", os.path.join(tmp, "inst")] + list(inst_opts)
        before = reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with watch_predict(counters) as w:
            trainer = train_net.main(["--config", INST_PRESET, "--max-iter", str(INST_STEPS)]
                                     + device_args + opts)
        t_run = time.time() - t0
        launches, by_route = take(before)
        cfg = trainer.cfg
        want = {n: per_step(cfg)[n] * INST_STEPS + per_image(cfg)[n] * len(inst_dicts)
                for n in counters}
        log(f"  {INST_PRESET}: launches {launches} (expected {want}); by route {by_route}")
        if cuda and launches != want:
            raise SystemExit(f"{INST_PRESET}: launched {launches}, expected {want}")
        report(INST_PRESET, trainer, w, INST_STEPS, INST_NAMES[1], len(inst_dicts), t_run)
        if cuda and (by_route["point_sample_bilinear"]["direct"] < 2 * INST_STEPS
                     or by_route["point_sample_backward"]["direct"] < INST_STEPS):
            raise SystemExit(f"{INST_PRESET}: point_sample took {by_route}; the 1024x1024 targets "
                             "and the 256x256 logits (forward and backward) belong to the direct "
                             "route")
        saved = os.path.join(cfg.OUTPUT_DIR, "coco_instances_results.json")
        with open(saved) as f:
            dets = json.load(f)
        log(f"  {INST_PRESET}: coco_instances_results.json holds {len(dets)} detections")
        # the trained model's own detections on the test images as ground
        # truth (its best three of nonempty mask on each), plus a triangle of
        # the best one's class that no detection covers and a crowd region:
        # a test() whose AP counts matches but cannot be 100
        nc = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        is_thing = thing_lookup(range(80), nc)
        mapper = MaskFormerInstanceDatasetMapper(is_train=False,
                                                 min_size_test=cfg.INPUT.MIN_SIZE_TEST,
                                                 max_size_test=cfg.INPUT.MAX_SIZE_TEST)
        own = []
        with trainer._eval_mode():
            for d, sample in zip(inst_dicts, eval_loader(inst_dicts, mapper)):
                h, w = d["height"], d["width"]
                logits, masks = trainer._predict_image(sample["image"])
                inst = instance_inference(logits, sem_seg_postprocess(masks, masks.shape[-2:], (h, w)),
                                          is_thing, nc, topk=cfg.TEST.DETECTIONS_PER_IMAGE)
                labels, annos = inst["labels"].tolist(), []
                for k, m in enumerate(inst["masks"].cpu().numpy()):
                    if len(annos) < 3 and m.any():
                        annos.append({"category_id": labels[k], "iscrowd": 0, "segmentation": {
                            "size": [h, w], "counts": [int(c) for c in rle_encode(m)["counts"]]}})
                annos.append({"category_id": labels[0], "iscrowd": 0,
                              "segmentation": [[4.0, 4.0, 40.0, 6.0, 10.0, 36.0]]})
                annos.append({"category_id": labels[1], "iscrowd": 1,
                              "segmentation": [[w / 2, h / 2, w - 8.0, h / 2, w - 8.0, h - 8.0]]})
                own.append({**d, "annotations": annos})
        DatasetCatalog.register(INST_OWN, lambda: [dict(d) for d in own])
        MetadataCatalog.get(INST_OWN).set(**inst_meta)
        trainer.cfg.defrost()          # train_net froze it
        trainer.cfg.DATASETS.TEST = [INST_OWN]
        before = reset()
        try:
            with watch_predict(counters) as w:
                ap = trainer.test()[INST_OWN]
        finally:
            DatasetCatalog.remove(INST_OWN)
            trainer.cfg.DATASETS.TEST = [INST_NAMES[1]]
        take(before)
        if cuda and any(r["launches"] != per_image(cfg) for r in w.images):
            raise SystemExit(f"test(): images launched {[r['launches'] for r in w.images]}")
        log(f"  {INST_PRESET} test() against ground truth made from its own detections "
            f"({[sum(not a['iscrowd'] for a in d['annotations']) for d in own]} instances, one "
            "missed, and a crowd region each): " + ", ".join(f"{k} {v:.4f}" for k, v in ap.items())
            + f"; post-processing {statistics.median(w.post_ms):.1f} ms an image")
        if not all(math.isfinite(v) for v in ap.values()) or not 0 < ap["AP"] < 100:
            raise SystemExit(f"test() against its own detections gave {ap}")
        d0 = inst_dicts[0]
        first = resize_shortest_edge(images[d0["file_name"]], None, cfg.INPUT.MIN_SIZE_TEST,
                                     cfg.INPUT.MAX_SIZE_TEST)[0]
        hold_instance(f"{INST_PRESET} test image {first.shape[:2]}", trainer, first,
                      (d0["height"], d0["width"]),
                      thing_lookup(range(80), cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES))
        loader = trainer.build_train_loader()
        try:
            batch = device_batch(next(loader), dev)
        finally:
            loader.close()
        log(f"  a batch of {INST_PRESET} from the loader: image {tuple(batch['image'].shape)}, "
            f"masks {tuple(batch['masks'].shape)}, targets per image "
            f"{batch['valid'].sum(1).tolist()}")
        if cuda:
            hold_step_operands(f"coco_lsj_b{INST_BATCH}_step", trainer.model, cfg, batch, gen,
                               paths)
            replay_step(INST_PRESET, trainer.model, cfg, batch, draw)
        del batch
        del trainer
        if cuda:
            torch.cuda.empty_cache()
    return phase_launches, paths


# the grid baselines' phase (15): Swin-B-384 at its published 640x640 crops
# and batch per GPU (SOLVER.IMS_PER_BATCH 16 over 8 GPUs), Mask2Former-R50
# at 512x512; ADE20K-shaped test() pairs, the second wider than 2048 once
# its short edge is 640
GRID_SWIN, GRID_SWIN_BATCH, GRID_SWIN_STEPS = "swin_base_384_res640", 2, 3
GRID_R50, GRID_R50_STEPS = "r50", 2
GRID_EVAL_SIZES = ((512, 683), (480, 1600), (640, 480))


def grid_launches(cfg, step: bool, size: int) -> dict:
    """Every kernel's launches in one forward (step False) or one training
    step of a grid baseline, from the config.  The R50's point-cloud pixel
    decoder: an msdetrpc per encoder layer and transformer level, knn for
    each level's 4-NN table and the FPN's Shepard upsample (its PointConv
    takes the dense-grid route: no knn); the Swin's grid pixel decoder and
    its grid attention mask launch nothing.  A step adds the backwards of
    those msdetrpc calls and the criterion's: K10 on the targets and the
    matched logits and the logits' backward, the ranking read through K12
    where the stratified route's rule takes the size / 4 wide masks and
    through K11 elsewhere, one K13 solve."""
    from autofocusformermod_torch.losses import point_sample as sampler
    from autofocusformermod_torch.ops.point_sample import point_sample_nearest_rows_supported

    head = cfg.MODEL.SEM_SEG_HEAD
    msdetrpc = knn_calls = 0
    if cfg.MODEL.META_ARCHITECTURE == "MaskFormer":
        levels = len(head.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES)
        msdetrpc, knn_calls = head.TRANSFORMER_ENC_LAYERS * levels, levels + 1
    fwd = {"msdetrpc": msdetrpc, "knn": knn_calls}
    if not step:
        return fwd
    mf, side = cfg.MODEL.MASK_FORMER, size // 4
    rows = int(sampler.STRATIFY_RANKING and point_sample_nearest_rows_supported(
        side, side, int(mf.TRAIN_NUM_POINTS * mf.OVERSAMPLE_RATIO)))
    return {**fwd, "msdetrpc_bwd": msdetrpc, "point_sample": 2, "point_sample_bwd": 1,
            "point_sample_nearest": 1 - rows, "point_sample_nearest_rows": rows, "lapjv": 1}


def hold_grid_step_operands(label, model, cfg, batch, gen, paths, local_attn=False):
    """K4 (R50), K10 (each route the masks give), the ranking's read (K11 or
    K12) and K13 on the operands of one real step, each against its plain
    version; with `local_attn` also K2 (a point-cloud backbone's step; a
    grid baseline's step must call none); records into
    paths[kernel][label]."""
    import torch
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.ops import point_sample as ops_ps

    ops = path_maskfiner_step_operands(model, cfg, batch,
                                       device_draw(torch.Generator(device=batch["image"].device)
                                                   .manual_seed(SEED)))
    la = ops.pop("local_attn_bwd")
    if la and not local_attn:
        raise SystemExit(f"{label}: a grid baseline's step called the local_attn backward")
    if la:
        paths.setdefault("local_attn_bwd", {})[label] = check_local_attn_bwd_calls(label, la)
    del la
    md = ops.pop("msdetrpc_bwd")
    if md:
        paths.setdefault("msdetrpc_bwd", {})[label] = msdetrpc_bwd_calls(label, md, gen)
    del md
    torch.cuda.empty_cache()
    groups = ops.pop("point_sample")
    paths.setdefault("point_sample", {})[label] = summed({
        "x".join(map(str, g["logits"][0].shape[-2:])): point_sample_calls(
            f"{label} {tuple(g['logits'][0].shape[-2:])}", g, gen) for g in groups.values()})
    del groups
    torch.cuda.empty_cache()
    for name in ("point_sample_nearest", "point_sample_nearest_rows"):
        for masks, *args in ops.pop(name):
            paths.setdefault(name, {})[label] = hold_nearest(
                f"{label} w{masks.shape[-1]}", getattr(ops_ps, name), masks, args)
    paths.setdefault("lapjv", {})[label] = lapjv_costs(label, ops.pop("lapjv")[0][0])
    del ops
    torch.cuda.empty_cache()


def grid_baselines_phase(dev, smi, gen, counters, swin_opts=(), r50_opts=(),
                         eval_sizes=GRID_EVAL_SIZES):
    """Phase 15: the grid baselines at their published widths and depths,
    seeded random weights.  For Swin-B-384 (GRID_SWIN, 640x640) and the R50
    (GRID_R50, 512x512) each: a forward (Swin-B at batch GRID_SWIN_BATCH,
    the R50 at BATCH and held against the plain run with its choices
    replayed: check_forward), the kernels of one real step on its own
    operands (hold_grid_step_operands; the R50's forward's K3 and K9 too),
    training steps (Swin-B GRID_SWIN_STEPS at batch GRID_SWIN_BATCH, the
    R50 GRID_R50_STEPS at TRAIN_BATCH) each replayed through the plain
    versions (replay_step) and then taken through the kernels by the
    Trainer's step, and Trainer.test() over ADE20K-shaped images (short edge
    640 and 512 after the mapper) with launches and ms per image; launches
    against grid_launches, ms per step, peak GiB, device busy share,
    images/s.  Returns ({kernel: {path: record}}, {counter: launches of the
    phase's runs through the kernels})."""
    import tempfile

    import torch
    from autofocusformermod_torch.config import PRESETS, train_image_size
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.maskformer import init_random_weights
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.ops.point_sample import point_sample_backward, point_sample_bilinear

    paths, total = {}, dict.fromkeys(counters, 0)

    def reset():
        for c in counters.values():
            c.launches = 0

    def draw(i):
        return device_draw(torch.Generator(device=dev).manual_seed(SEED + i))

    def expect(label, got, want):
        want = {n: want.get(n, 0) for n in counters}
        if got != want:
            raise SystemExit(f"{label}: launched {got}, expected {want}")

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pairs = eval_dataset(eval_sizes)
    for preset, opts, b_fwd, b_step, n_steps in (
            (GRID_SWIN, swin_opts, GRID_SWIN_BATCH, GRID_SWIN_BATCH, GRID_SWIN_STEPS),
            (GRID_R50, r50_opts, BATCH, TRAIN_BATCH, GRID_R50_STEPS)):
        # a Trainer made within watch_eval keeps its pad-fringe hook for test()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="grid_") as tmp, \
                semantic_files(pairs), watch_eval(counters) as watch:
            cfg = PRESETS[preset]()
            cfg.merge_from_list([*opts, "SOLVER.IMS_PER_BATCH", str(b_step), "OUTPUT_DIR", tmp,
                                 "DATASETS.TEST", f"('{EVAL_NAMES[1]}',)"])
            size = train_image_size(cfg)[0]
            trainer = Trainer(cfg, dev)
            model = trainer.model
            init_random_weights(model, torch.Generator().manual_seed(SEED))
            n_params = sum(p.numel() for p in model.parameters())
            fwd_want, step_want = grid_launches(cfg, False, size), grid_launches(cfg, True, size)
            log(f"  {preset}: {cfg.MODEL.META_ARCHITECTURE}, {cfg.MODEL.BACKBONE.NAME}, "
                f"{n_params / 1e6:.2f}M parameters, {size}x{size}; launches expected per forward "
                f"{fwd_want}, per step {step_want}")

            # the forward
            images = torch.randint(0, 256, (b_fwd, size, size, 3), generator=gen,
                                   dtype=torch.uint8).to(dev)
            model.eval()
            with torch.no_grad():
                reset()
                book = {}
                with same_choices(book, record=True):
                    out, first_ms, got = counted_call(counters, lambda: model(images))
                expect(f"{preset} forward", got, fwd_want)
                for name, n in got.items():
                    total[name] += n
                _, fwd_ms, _ = counted_call(counters, lambda: model(images))
                if preset == GRID_R50:
                    with same_choices(book, record=False), plain_versions():
                        ref = model(images)
                    check_forward(f"{preset} forward", out, ref, book, b_fwd, size)
                    del ref
                else:
                    shape = (b_fwd, 100, size // 4, size // 4)
                    if tuple(out["pred_masks"].shape) != shape or not all(
                            torch.isfinite(out[k]).all() for k in ("pred_logits", "pred_masks")):
                        raise SystemExit(f"{preset} forward: masks {tuple(out['pred_masks'].shape)}"
                                         f" (expected {shape}) or non-finite outputs")
                busy, rows = device_busy(lambda: model(images), runs=2)
                if preset == GRID_R50:
                    fwd_ops = path_forward_operands(model, images[:1])
                    for name, check in (("msdetrpc", check_msdetrpc), ("knn", check_knn)):
                        paths.setdefault(name, {})[f"{preset}_forward"] = check(
                            f"{preset} forward", fwd_ops[name])
                    del fwd_ops
            log(f"  {preset} forward, batch {b_fwd}: {fwd_ms:.1f} ms (first {first_ms:.1f}), "
                f"{b_fwd / fwd_ms * 1e3:.2f} images/s; device busy {busy:.2f} ms in {rows:.0f} "
                f"rows ({busy / fwd_ms:.0%}); launches {got} ({smi})")
            del images, out, book
            torch.cuda.empty_cache()

            # the kernels on one real step's operands, then the steps
            model.train()
            batches = synthetic_batches(cfg, dev)
            hold_grid_step_operands(f"{preset}_step", model, cfg, next(batches), gen, paths)
            times, peaks = [], []
            for i in range(n_steps):
                batch = next(batches)
                used, _, p_ms, _, p_peak = replay_step(f"{preset} step {i + 1}", model, cfg, batch,
                                                       lambda: draw(i + 1))
                by_route = [dict(fn.launches_by_route)
                            for fn in (point_sample_bilinear, point_sample_backward)]
                reset()
                torch.cuda.reset_peak_memory_stats()
                metrics, ms, got = counted_call(counters, lambda: trainer.step_fn(batch, draw(i + 1)))
                times.append(ms)
                peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
                by_route = [{r: fn.launches_by_route[r] - n[r] for r in n} for fn, n in
                            zip((point_sample_bilinear, point_sample_backward), by_route)]
                for name, n in got.items():
                    total[name] += n
                log(f"  {preset} step {i + 1} through the kernels at batch {b_step}: {ms:.1f} ms, "
                    f"peak {peaks[-1]:.2f} GiB, total loss {metrics['total_loss'].item():.6f}, "
                    f"grad_norm {metrics['grad_norm'].item():.5f}; point_sample by route: forward "
                    f"{by_route[0]}, backward {by_route[1]}; the plain step (batch {used}) "
                    f"{p_ms:.1f} ms, peak {p_peak:.2f} GiB")
                expect(f"{preset} step {i + 1}", got, step_want)
                if by_route[1]["direct"] or not by_route[0]["direct"]:
                    raise SystemExit(f"{preset} step {i + 1}: point_sample took {by_route}; the "
                                     f"{size}x{size} targets belong to the direct route, the "
                                     "logits' backward to the shared one")
                if len(metrics) != 2 + 3 * cfg.MODEL.MASK_FORMER.DEC_LAYERS or not all(
                        torch.isfinite(v).all() for v in metrics.values()):
                    raise SystemExit(f"{preset} step {i + 1}: {len(metrics)} metrics, or non-finite")
                del batch
            ms = statistics.median(times[1:]) if len(times) > 1 else times[0]

            def one_step():
                trainer.step_fn(next(batches), draw(0))
                torch.cuda.synchronize()

            reset()
            busy, rows = device_busy(one_step, runs=1)
            for name, c in counters.items():
                total[name] += c.launches
            log(f"  {preset} ms per step at batch {b_step} (median of steps 2-{n_steps}): "
                f"{ms:.1f} = {b_step / ms * 1e3:.2f} images/s, peak {max(peaks):.2f} GiB; device "
                f"busy {busy:.2f} ms per step in {rows:.0f} rows ({busy / ms:.0%} of the step) "
                f"({smi})")
            del batches
            torch.cuda.empty_cache()

            # test() over the ADE20K-shaped images
            reset()
            t0 = time.time()
            results = trainer.test()
            torch.cuda.synchronize()
            dt = time.time() - t0
            for name, c in counters.items():
                total[name] += c.launches
            miou = results[EVAL_NAMES[1]]["mIoU"]
            inputs = [rec["input"] for rec in watch.images]
            log(f"  {preset} test() on {len(watch.images)} images: {dt:.2f} s = "
                f"{len(watch.images) / dt:.2f} images/s, mIoU {miou:.4f}; ms per image by padded "
                f"input {ms_by_size(watch.images)}; launches per image "
                f"{[rec['launches'] for rec in watch.images]} ({smi})")
            if len(watch.images) != len(eval_sizes) or not math.isfinite(miou):
                raise SystemExit(f"{preset} test(): {len(watch.images)} images, mIoU {miou}")
            if watch.fringe[1] or not watch.fringe[0]:
                raise SystemExit(f"{preset} test(): {watch.fringe[1]} of {watch.fringe[0]} pad "
                                 "pixels of the model's input are not the rounded pixel mean")
            for rec in watch.images:
                expect(f"{preset} test() image {rec['input']}", rec["launches"], fwd_want)
            short = cfg.INPUT.MIN_SIZE_TEST
            if min(min(hw) for hw in inputs) < short or (
                    preset == GRID_SWIN and max(hw[1] for hw in inputs) <= 2048):
                raise SystemExit(f"{preset} test(): padded inputs {inputs}; short edges of "
                                 f"{short}, one wider than 2048 expected")
            del trainer, model, watch
            torch.cuda.empty_cache()
    return paths, total


UPDOWN, UPDOWN_STEPS = "maskfiner_updown_mini", 2
# the Trainer.test() images of phase 16, and its sliding window under
# MaskFinerOracleTeacherSW (two windows across each 512x704 padded input)
UPDOWN_EVAL_SIZES = EVAL_SIZES[:2]
UPDOWN_SW = (["TEST.SW_CROP_SIZE", "[512, 512]", "TEST.SW_STRIDE", "[384, 384]"], 2)


def check_head_outputs(label, out, ref, book, scored="upsampling_preds", by_scores=(),
                       rtol=FORWARD_RTOL, mean_rtol=None, floors=None, near_tie_floors=None):
    """A forward through the kernels against the plain run, which replayed
    the kernel run's choices: the final and every aux output and each of
    the `scored` scores (an OracleTeacher model's upsampling scores, an
    MRML model's meta-loss predictions) within `rtol` of their largest
    |entry| (at least 1), and with `mean_rtol` their mean |difference|
    within that share of their mean |entry|; the choices to `floors`
    (CHOICE_AGREE_MIN by default; a kind measured against its scores,
    same_choices near_ties, to `near_tie_floors` where the scores explain
    every flip) but `by_scores` (logged: the scores that order them are
    held here).  The OracleTeacher-BB upsampling heads end in a
    LayerNorm over one channel, so their scores are their norm's bias: each
    stage's split order is the tokens' own order (a stable sort of equal
    keys) in both runs.  -> {output kind: worst max rel} (and
    "<kind> mean": worst mean rel, with `mean_rtol`)."""
    import torch

    pairs = [(key, out[key], ref[key]) for key in ("pred_logits", "pred_masks")]
    pairs += [(f"aux {i} {key}", a[key], r[key])
              for i, (a, r) in enumerate(zip(out["aux_outputs"], ref["aux_outputs"]))
              for key in ("pred_logits", "pred_masks")]
    pairs += [(f"{scored.split('_')[0]} score {i}", a, r)
              for i, (a, r) in enumerate(zip(out.get(scored, ()), ref.get(scored, ())))]
    if len(out["aux_outputs"]) != len(ref["aux_outputs"]):
        raise SystemExit(f"{label}: {len(out['aux_outputs'])} aux outputs against "
                         f"{len(ref['aux_outputs'])}")
    worst, over = {}, []
    for key, a, r in pairs:
        if a.shape != r.shape or not torch.isfinite(a).all():
            raise SystemExit(f"{label} {key}: shape {tuple(a.shape)} against {tuple(r.shape)}, or "
                             "non-finite")
        diff = (a - r).abs()
        e = diff.max().item()
        rel = e / max(r.abs().max().item(), 1.0)
        kind = " ".join(key.split()[::2]) if key.startswith("aux") else key.rstrip("0123456789 ")
        worst[kind] = max(worst.get(kind, 0.0), rel)
        if rel > rtol:
            over.append(f"{key}: {e} ({rel:.3e} of its largest entry)")
        if mean_rtol is not None:
            mean = diff.float().mean().item() / max(r.abs().float().mean().item(), 1e-12)
            worst[kind + " mean"] = max(worst.get(kind + " mean", 0.0), mean)
            if mean > mean_rtol:
                over.append(f"{key}: mean |difference| {mean:.3e} of its mean |entry|")
    log(f"    worst max_abs_err / max |ref| per output"
        + (" (and mean |difference| / mean |ref|)" if mean_rtol is not None else "") + ": "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" ({len(pairs)} outputs, limit {rtol}"
        + (f", mean {mean_rtol}" if mean_rtol is not None else "") + ")")
    if over:
        raise SystemExit(f"{label}: kernels and plain versions disagree: " + "; ".join(over))
    same_choices.check(label, book, by_scores, floors, near_tie_floors)
    return worst


def updown_stream(cfg, model, images):
    """An OracleTeacher-BB forward's token stream: each down stage's scale
    segments and each up stage's tokens -> (log text, record fields)."""
    import torch

    mr, n = cfg.MODEL.MR, cfg.MODEL.MASK_FINER.NUM_RESOLUTION_SCALES
    with torch.no_grad():
        # fp32 on the masters (an AMP model too): only the segments' sizes are read
        feats = model.backbone(model.normalize(images).float())
    segs = [feats[f"upsampling_mask_pred_{s}"].shape[1] for s in range(n - 1)]
    segs.append(feats["res2"].shape[1])
    down = [tuple(segs[:s + 1]) for s in range(n)]
    up = [sum(segs[:n - 1 - j]) for j in range(n - 1)]
    size = images.shape[1]
    text = ("down stages' segments " + ", ".join(f"{s}: {d} = {sum(d)}" for s, d in enumerate(down))
            + "; up stages' tokens " + ", ".join(
                f"{n + j}: {k} ({'global' if mr.NAME[n + j] == 'MixResViT' else 'clusters'})"
                for j, k in enumerate(up)) + f"; dense decoder grid {size // 4}x{size // 4}")
    return text, {"down_segments": down, "up_tokens": up}


def updown_phase(dev, smi, gen, counters, opts=(), size=SIZE, eval_sizes=UPDOWN_EVAL_SIZES,
                 sw=UPDOWN_SW, out_dir="chiprun_out"):
    """Phase 16: the published MaskFiner-UpDown-Mini (MaskFinerOracleTeacherBB:
    the UpDownBackbone's 7 MixRes stages, the final stage's pixel decoder,
    the dense OracleTeacher decoder) through family_phase: the token stream
    (updown_stream), the kernels on a forward's and a step's operands, the
    forward and UPDOWN_STEPS steps against the plain versions (launches
    against family_launches), test() on `eval_sizes` ADE20K-shaped images,
    and again with the same weights under MaskFinerOracleTeacherSW (`sw`:
    the window overrides and the windows per image).  Writes the record to
    out_dir/updown_phase16.json.  Returns ({kernel: {path: record}},
    {counter: launches of the phase's runs through the kernels})."""
    import os

    record, paths, total = family_phase(
        dev, smi, gen, counters, UPDOWN, True, opts, size, eval_sizes, UPDOWN_STEPS,
        stream=updown_stream, test_under=(("MaskFinerOracleTeacherSW", sw[0], sw[1]),))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "updown_phase16.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    return paths, total


# the last two model families' phase (17): the OracleTeacher cascade and the
# MRML family at 512x512; the first two run in full (their kernels on their
# own operands, FAMILY_STEPS steps, test()), the global-attention MRML
# presets a forward and a step each
OT, MRMLNB, MRML, MRMEAN = "maskfiner_oracle_teacher", "mrmlnb_mini", "mrml_mini", "mrmean_mini"
# the script's time limit: phases 16 and 17 run their presets at their
# published widths but one block a stage, so that phase 19 runs UpDown-Tiny
# whole (phase 14's AFF-Mini keeps its depth: at a cut one its trained model
# makes no detection to hold test() against)
UPDOWN_DEPTHS = ["MODEL.MR.DEPTHS", "[1, 1, 1, 1, 1, 1, 1]"]
FAMILY_DEPTHS = {OT: ["MODEL.MR.DEPTHS", "[1, 1, 1, 1]"],
                 **{name: ["MODEL.MRML.DEPTHS", "[1, 1, 1, 1]"] for name in (MRMLNB, MRML, MRMEAN)}}
FAMILY_STEPS = 2
FAMILY_EVAL_SIZES = EVAL_SIZES[:2]


def family_segments(cfg, hw) -> list:
    """The scale segments of the token stream each stage or scale runs on at
    (h, w): the newest scale's top tokens split 4 ways by the OracleTeacher's
    rule (int(n * UPSCALE_RATIO), the old scale kept) or the MRML one
    (max(1, int(n * UPSCALE_RATIO)), the split parents dropped)."""
    h, w = hw
    if cfg.MODEL.META_ARCHITECTURE.startswith("MaskFiner"):
        mr = cfg.MODEL.MR
        segs = [(h // mr.PATCH_SIZES[0]) * (w // mr.PATCH_SIZES[0])]
        out = [tuple(segs)]
        for li in range(1, len(mr.NAME)):
            segs = segs + [4 * min(max(1, int(segs[-1] * mr.UPSCALE_RATIO[li])), segs[-1])]
            out.append(tuple(segs))
        return out
    m = cfg.MODEL.MRML
    segs = [(h // m.PATCH_SIZES[0]) * (w // m.PATCH_SIZES[0])]
    out = [tuple(segs)]
    for _ in range(m.NUM_SCALES - 1):
        k = max(1, int(segs[-1] * m.UPSCALE_RATIO))
        segs = segs[:-1] + [segs[-1] - k, 4 * k]
        out.append(tuple(segs))
    return out


def family_launches(cfg, step: bool, hw=(SIZE, SIZE)) -> dict:
    """Every kernel's launches in one forward (step False) or one training
    step of a MaskFiner OracleTeacher cascade or an MRML model at (h, w),
    from the config: a local attention per block of a clustered stage (the
    MixResNeighbour stages, and an UpDownBackbone's down stages after the
    first, whatever their names; the MixResViT ones attend globally; an MRML Neighbour scale whose
    stream passes its neighbourhood, NBHD_SIZE tokens) and a knn for its clusters; a
    knn per transformer level's 4-NN table and, per FPN level, its Shepard
    upsample and the knn PointConv (the level does not cover its grid); the
    Up decoder's Shepard onto the grid; the masked decoder's Shepard
    neighbours per level where the mask features do not cover the mask
    canvas (the dense OracleTeacher decoder and a full canvas find theirs in
    a window); msdetrpc per encoder layer and transformer level.  A step
    adds a K2 and a K4 per K1 and K3 call and the criterion's (one mask
    shape: K10 on the targets, the matched logits and their backward, the
    ranking's read, one K13)."""
    from autofocusformermod_torch.losses import point_sample as sampler
    from autofocusformermod_torch.models.mrml import MRML_BACKBONES, NBHD_SIZE
    from autofocusformermod_torch.ops.point_sample import point_sample_nearest_rows_supported

    h, w = hw
    if cfg.MODEL.META_ARCHITECTURE.startswith("MaskFiner"):
        mr, head, mf = cfg.MODEL.MR, cfg.MODEL.MR_SEM_SEG_HEAD, cfg.MODEL.MASK_FINER
        n, updown = mf.NUM_RESOLUTION_SCALES, cfg.MODEL.BACKBONE.NAME == "UpDownBackbone"
        clustered = [t for t, name in enumerate(mr.NAME)
                     if name == "MixResNeighbour" or (updown and 0 < t < n)]
        depths, layers = mr.DEPTHS, head.TRANSFORMER_ENC_LAYERS[n - 1]
        side = (h // mr.PATCH_SIZES[n - 1], w // mr.PATCH_SIZES[n - 1])
        extra = 0
    else:
        m, head, mf = cfg.MODEL.MRML, cfg.MODEL.SEM_SEG_HEAD, cfg.MODEL.MASK_FORMER
        segs = family_segments(cfg, hw)
        cluster = MRML_BACKBONES.get(cfg.MODEL.BACKBONE.NAME, (False,))[0]
        # a Neighbour scale attends globally up to one neighbourhood's tokens
        clustered = [l for l, s in enumerate(segs) if cluster and sum(s) > NBHD_SIZE]
        depths, layers = m.DEPTHS, head.TRANSFORMER_ENC_LAYERS
        side = (h // 4, w // 4)
        up = (cfg.MODEL.META_ARCHITECTURE == "MaskFormerML"
              and head.PIXEL_DECODER_NAME == "MSDeformAttnPixelDecoderUp")
        covers = up or segs[-1][-1] == side[0] * side[1]
        extra = int(up) + (0 if covers else min(3, mf.DEC_LAYERS))
    n_trans = len(head.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES)
    fwd = {"local_attn": sum(depths[l] for l in clustered), "msdetrpc": layers * n_trans,
           "knn": len(clustered) + n_trans + 2 * (len(head.IN_FEATURES) - n_trans) + extra}
    if not step:
        return fwd
    points = int(mf.TRAIN_NUM_POINTS * mf.OVERSAMPLE_RATIO)
    rows = int(sampler.STRATIFY_RANKING and point_sample_nearest_rows_supported(*side, points))
    return {**fwd, "local_attn_bwd": fwd["local_attn"], "msdetrpc_bwd": fwd["msdetrpc"],
            "point_sample": 2, "point_sample_bwd": 1, "point_sample_nearest": 1 - rows,
            "point_sample_nearest_rows": rows, "lapjv": 1}


def family_stream(cfg, model, images):
    """The token stream each stage or scale runs on, from the config (the
    family_segments of the images' size) -> (log text, record fields)."""
    segs = family_segments(cfg, tuple(images.shape[1:3]))
    return ", ".join(f"{s}: {d} = {sum(d)}" for s, d in enumerate(segs)), {"segments": segs}


def family_phase(dev, smi, gen, counters, preset, full=True, opts=(), size=SIZE,
                 eval_sizes=FAMILY_EVAL_SIZES, steps=FAMILY_STEPS, launches=family_launches,
                 stream=family_stream, test_under=(), near_ties=False):
    """One preset of phases 16 and 17 at size x size from a Trainer (seeded
    random weights): the token stream (`stream`); with `full`, K1, K3 and K9
    on the operands of a real batch-BATCH forward, each against its plain
    version; the forward through the kernels (launches against `launches`,
    (cfg, step, (h, w)) -> {counter: launches}) and through the plain
    versions replaying its choices (check_head_outputs: the final and aux
    outputs, the OracleTeacher's scores or the MRML meta-loss predictions),
    ms and device busy of both; with `full`, K2, K4, K10, the ranking's read
    and K13 on a real step's operands; `steps` steps at batch BATCH
    (synthetic label maps, 100 target slots), each replayed through the
    plain versions (replay_step) and then taken by the Trainer's step
    (launches, loss_upsampling or meta_loss finite and above 0, ms, peak
    GiB, device busy); with `full`, test() on `eval_sizes` ADE20K-shaped
    images, then with the same weights under each (meta-architecture,
    overrides, windows per image) of `test_under`.  near_ties: the steps'
    matches and ranked points are measured against their scores
    (replay_step).  -> (record, {kernel:
    {path: record}}, {counter: launches of the preset's runs through the
    kernels})."""
    import contextlib
    import tempfile

    import torch
    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.maskformer import init_random_weights
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.tools.l2_rate import l2_read_rate

    paths, total, record = {}, dict.fromkeys(counters, 0), {"card": smi, "size": size}

    def reset():
        for c in counters.values():
            c.launches = 0

    def draw(i):
        return device_draw(torch.Generator(device=dev).manual_seed(SEED + i))

    def expect(label, got, want):
        want = {n: want.get(n, 0) for n in counters}
        if got != want:
            raise SystemExit(f"{label}: launched {got}, expected {want}")

    def add(got):
        for name, k in got.items():
            total[name] += k

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pairs = eval_dataset(eval_sizes)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="family_") as tmp, \
            semantic_files(pairs), watch_eval(counters) as watch:
        cfg = PRESETS[preset]()
        cfg.merge_from_list([*opts, "SOLVER.IMS_PER_BATCH", str(BATCH), "OUTPUT_DIR", tmp,
                             "INPUT.CROP.SIZE", f"[{size}, {size}]",
                             "DATASETS.TEST", f"('{EVAL_NAMES[1]}',)"])
        arch = cfg.MODEL.META_ARCHITECTURE
        trainer = Trainer(cfg, dev)
        model = trainer.model
        init_random_weights(model, torch.Generator().manual_seed(SEED))
        n_params = sum(p.numel() for p in model.parameters())
        fwd_want = launches(cfg, False, (size, size))
        step_want = launches(cfg, True, (size, size))
        scored = "upsampling_preds" if arch.startswith("MaskFiner") else "metaloss_preds"
        images = torch.randint(0, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(SEED + 3)).to(dev)
        model.eval()
        text, fields = stream(cfg, model, images)
        log(f"  {preset}: {arch} over {cfg.MODEL.BACKBONE.NAME}; {n_params / 1e6:.2f}M "
            f"parameters; the token stream at {size}x{size}: {text}; launches expected per "
            f"forward {fwd_want}, per step {step_want}")
        record.update(parameters=n_params, **fields)
        if full:
            ops = path_forward_operands(model, images)
            if ops["local_attn"]:
                paths["local_attn"] = {preset: check_local_attn_calls(preset, ops["local_attn"])}
            paths["msdetrpc"] = {preset: check_msdetrpc(preset, ops["msdetrpc"], l2_read_rate())}
            paths["knn"] = {preset: check_knn(preset, ops["knn"])}
            shapes = {}
            for args in ops["local_attn"]:
                shapes[tuple(args[0].shape)] = shapes.get(tuple(args[0].shape), 0) + 1
            log(f"  local_attn (b, heads, n, c_) of the forward: {shapes}; msdetrpc (levels, "
                f"pairs, c_): "
                f"{sorted({(len(c[3]), c[0].shape[2], c[2].shape[2]) for c in ops['msdetrpc']})}"
                f"; knn (queries, database, k): "
                f"{sorted({(q.shape[1], d.shape[1], k) for _, q, d, k in ops['knn']})}")
            record["kernel_shapes"] = {"local_attn": {str(k): v for k, v in shapes.items()}}
            del ops
            torch.cuda.empty_cache()

        # the forward through the kernels, then the plain versions replaying its choices
        book = {}
        with torch.no_grad():
            reset()
            with same_choices(book, record=True):
                out, first_ms, got = counted_call(counters, lambda: model(images))
            expect(f"{preset} forward", {k: got[k] for k in counters}, fwd_want)
            add(got)
            with same_choices(book, record=False), plain_versions():
                ref = model(images)
            if tuple(out["pred_masks"].shape) != (BATCH, 100, size // 4, size // 4):
                raise SystemExit(f"{preset}: pred_masks {tuple(out['pred_masks'].shape)}")
            record["forward_worst_rel"] = check_head_outputs(
                f"{preset} forward", out, ref, book, scored,
                by_scores=("meta-loss split",) if arch == "MaskFormerML" else ())
            record["scores_shapes"] = [tuple(s.shape) for s in out.get(scored, ())]
            del out, ref, book

            def forward_ms(path):
                times = []
                for _ in range(4):
                    with path():
                        _, ms, _ = counted_call(counters, lambda: model(images))
                    times.append(ms)
                with path():
                    busy, rows = device_busy(lambda: model(images), runs=2)
                return statistics.median(times[1:]), busy, rows

            reset()
            k_ms, k_busy, k_rows = forward_ms(contextlib.nullcontext)
            p_ms, p_busy, p_rows = forward_ms(plain_versions)
            add({name: c.launches for name, c in counters.items()})
        log(f"  {preset} ms per batch-{BATCH} forward (median of 3 after one; first "
            f"{first_ms:.1f}): kernels {k_ms:.2f} (device busy {k_busy:.2f} ms in {k_rows:.0f} "
            f"rows, {k_busy / k_ms:.0%}), plain versions {p_ms:.2f} (busy {p_busy:.2f} ms in "
            f"{p_rows:.0f} rows) = {BATCH / k_ms * 1e3:.2f} images/s ({smi})")
        record["forward"] = {"batch": BATCH, "first_ms": first_ms, "ms": k_ms, "busy_ms": k_busy,
                             "plain_ms": p_ms, "plain_busy_ms": p_busy, "launches": got}
        del images
        torch.cuda.empty_cache()

        # the kernels on a real step's operands, then the steps
        model.train()
        batches = synthetic_batches(cfg, dev)
        if full:
            hold_grid_step_operands(f"{preset}_step", model, cfg, next(batches), gen, paths,
                                    local_attn=bool(step_want["local_attn_bwd"]))
        extra = "loss_upsampling" if arch.startswith("MaskFiner") else (
            "meta_loss" if arch == "MaskFormerML" else None)
        n_out = (cfg.MODEL.MASK_FINER.DEC_LAYERS[-1] if arch.startswith("MaskFiner")
                 else cfg.MODEL.MASK_FORMER.DEC_LAYERS)
        record["steps"] = []
        for i in range(steps):
            batch = next(batches)
            used, r_ms, p_ms, r_peak, p_peak = replay_step(f"{preset} step {i + 1}", model, cfg,
                                                           batch, lambda: draw(i + 1), near_ties)
            reset()
            torch.cuda.reset_peak_memory_stats()
            metrics, ms, got = counted_call(counters, lambda: trainer.step_fn(batch, draw(i + 1)))
            add(got)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            term = metrics[extra].item() if extra else None
            log(f"  {preset} step {i + 1} through the kernels at batch {BATCH}: {ms:.1f} ms, peak "
                f"{peak:.2f} GiB, total loss {metrics['total_loss'].item():.6f}"
                + (f", {extra} {term:.6g}" if extra else "")
                + f", grad_norm {metrics['grad_norm'].item():.5f}; the plain step (batch {used}) "
                f"{p_ms:.1f} ms, peak {p_peak:.2f} GiB")
            expect(f"{preset} step {i + 1}", got, step_want)
            if len(metrics) != 2 + 3 * n_out + int(extra is not None) or not all(
                    torch.isfinite(v).all() for v in metrics.values()) or (
                    extra and not term > 0):
                raise SystemExit(f"{preset} step {i + 1}: {len(metrics)} metrics (expected "
                                 f"{2 + 3 * n_out + int(extra is not None)}), non-finite, or "
                                 f"{extra} {term}")
            record["steps"].append({"ms": ms, "peak_gib": peak, "plain_ms": p_ms,
                                    "plain_peak_gib": p_peak, extra or "loss": term,
                                    "launches": got})
            del batch

        def one_step():
            trainer.step_fn(next(batches), draw(0))
            torch.cuda.synchronize()

        reset()
        busy, rows = device_busy(one_step, runs=1)
        add({name: c.launches for name, c in counters.items()})
        ms = record["steps"][-1]["ms"]
        log(f"  {preset} ms per step at batch {BATCH} (step {steps}): {ms:.1f} = "
            f"{BATCH / ms * 1e3:.2f} images/s, peak "
            f"{max(s['peak_gib'] for s in record['steps']):.2f} GiB; device busy {busy:.2f} ms "
            f"per step in {rows:.0f} rows ({busy / ms:.0%}) ({smi})")
        record["step_busy_ms"] = busy
        del batches
        torch.cuda.empty_cache()

        for test_arch, extra, windows in ((arch, [], 1), *test_under) if full else ():
            if test_arch != cfg.MODEL.META_ARCHITECTURE:
                # the same weights under another meta-architecture
                cfg.merge_from_list(["MODEL.META_ARCHITECTURE", test_arch, *extra])
                trainer = Trainer(cfg, dev)
                trainer.model.load_state_dict(model.state_dict())
                model = trainer.model
            start = len(watch.images)
            reset()
            t0 = time.time()
            results = trainer.test()
            torch.cuda.synchronize()
            dt = time.time() - t0
            add({name: c.launches for name, c in counters.items()})
            recs = watch.images[start:]
            miou = results[EVAL_NAMES[1]]["mIoU"]
            log(f"  {preset} {test_arch} test() on {len(recs)} images: {dt:.2f} s, mIoU "
                f"{miou:.4f}; ms per image by padded input {ms_by_size(recs)}; launches per image "
                f"{[rec['launches'] for rec in recs]} ({smi})")
            if len(recs) != len(eval_sizes) or not math.isfinite(miou):
                raise SystemExit(f"{preset} {test_arch} test(): {len(recs)} images, mIoU {miou}")
            for rec in recs:
                want = launches(cfg, False, rec["input"])
                expect(f"{preset} {test_arch} test() image {rec['input']}", rec["launches"],
                       {k: v * windows for k, v in want.items()})
            record[f"test_{test_arch}"] = {"seconds": dt, "mIoU": miou,
                                           "ms_by_input": ms_by_size(recs)}
        if full and (watch.fringe[1] or not watch.fringe[0]):
            raise SystemExit(f"{preset} test(): {watch.fringe[1]} of {watch.fringe[0]} pad "
                             "pixels of the model's input are not the rounded pixel mean")
        del trainer, model
        torch.cuda.empty_cache()
    record["kernels"] = paths
    return record, paths, total


def families_phase(dev, smi, gen, counters, presets=((OT, True), (MRMLNB, True), (MRML, False),
                                                     (MRMEAN, False)),
                   opts=None, size=SIZE, eval_sizes=FAMILY_EVAL_SIZES, steps=FAMILY_STEPS,
                   out_dir="chiprun_out"):
    """Phase 17: family_phase for each of `presets` ((name, full): `steps`
    steps where full, else one), its steps' matches and ranked points
    measured against their scores (NEAR_TIE_AGREE_MIN); `opts`: {name:
    config overrides}.  Writes every record to
    out_dir/phase17.json.  Returns ({kernel: {path: record}}, {counter:
    launches of the phase's runs through the kernels})."""
    import os

    records, paths, total = {}, {}, dict.fromkeys(counters, 0)
    for name, full in presets:
        t0 = time.time()
        rec, p, launched = family_phase(dev, smi, gen, counters, name, full,
                                        (opts or {}).get(name, ()), size, eval_sizes,
                                        steps if full else 1, near_ties=True)
        rec["seconds"] = time.time() - t0
        log(f"  {name} took {rec['seconds']:.1f} s")
        records[name] = rec
        for kernel, by_path in p.items():
            paths.setdefault(kernel, {}).update(by_path)
        for n, k in launched.items():
            total[n] += k
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "phase17.json"), "w") as f:
        json.dump(records, f, indent=1, default=str)
    return paths, total


# phase 19: bf16 mixed precision (SOLVER.AMP.ENABLED, parallel/precision.py)
# at the published COCO-panoptic MaskFiner-UpDown-Tiny, full width and depth,
# 1024x1024 (the LSJ canvas), batch 2
AMP_PRESET, AMP_SIZE, AMP_BATCH, AMP_STEPS = "maskfiner_updown_tiny_coco_panoptic", 1024, 2, 2
AMP_EVAL_SIZES = ((480, 640), (640, 427))
AMP_NAMES = ("smoke_coco_panoptic_train", "smoke_coco_panoptic_val")
COCO_PANOPTIC_CLASSES, COCO_THINGS = 133, tuple(range(80))
# Under AMP the kernels' fp32 results are rounded to bf16 after each call: a
# last-bit difference between a kernel and its plain version moves an
# element's bf16 rounding by 2**-8 of it, and such moves compound through
# the layers.  The kernel run is held to the plain run (choices replayed)
# at these budgets: the forward's outputs' largest difference relative to
# their largest entry and their mean difference relative to their mean
# entry, the step's loss terms, its gradient norm per optimizer group.
AMP_FORWARD_RTOL, AMP_FORWARD_MEAN_RTOL = 0.1, 5e-2
AMP_LOSS_RTOL, AMP_GROUP_NORM_RTOL = 2e-2, 2e-2
# the plain run's own choices against the kernel run's: bf16 rounding moved
# by a kernel's last bit flips near ties far more often than in fp32 (an
# AMP forward at 1024x1024: sampling cells 0.980, attention masks 0.998;
# a step's ranked points 0.964, matches 0.20-0.29 of all slots, on an
# H100).  Phase 19 holds these floors; a match or a ranked point
# under its floor passes where every flip is one the two runs' scores
# explain (same_choices.near_tie), as in phase 17.  The matches of the
# target slots that hold a target ("valid matches": 1170-1230 of the 2000)
# are held to a floor of their own without that exemption: at random
# initialisation 0.22-0.27 of them agree (queries tie), and a matcher that
# assigned the 100 queries at random would agree on ~0.01.
AMP_CHOICE_AGREE_MIN = {**CHOICE_AGREE_MIN, "sampling cells": 0.95, "attention masks": 0.99,
                        "ranked points": 0.95, "matches": 0.95, "valid matches": 0.1}
AMP_NEAR_TIE_AGREE_MIN = {"matches": 0.0, "ranked points": 0.9, "class votes": 0.99}
# each loss term of the AMP steps against the same steps in fp32 (same
# initial weights, batches, draws and DropPath draws; the fp32 run replays
# the AMP run's discrete choices): within AMP_FP32_BUDGET, and the worst
# term at least AMP_FP32_MIN apart (two fp32 runs replaying each other's
# choices part by summation order alone, LOSS_RTOL)
AMP_FP32_BUDGET, AMP_FP32_MIN = 5e-2, 1e-3
# the share of the AMP forward's parameterised leaf modules (those that hold
# parameters and no submodule) whose float outputs are all bf16 (every one
# of UpDown-Tiny's: sampling_offsets, kept fp32, is applied without its
# module's forward)
AMP_BF16_SHARE_MIN = 1.0
# the first backbone stage's features and positions in the AMP forward
AMP_STAGE1_DTYPES = ("torch.bfloat16", "torch.float32")


def coco_panoptic_pairs(sizes, seed=SEED):
    """[(dataset dict, image, panoptic ids, semantic map)] shaped as COCO
    panoptic: stuff of classes 80-132 in 64-pixel blocks (segment id =
    class + 1), 4-12 thing instances (ellipses of classes 0-79, ids
    (class + 1) * 1000 + k), a void band (id 0, semantic 255) along the
    bottom; the semantic map holds each pixel's class."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i, (h, w) in enumerate(sizes):
        img = smooth_image(rng, h, w)
        stuff = rng.integers(80, COCO_PANOPTIC_CLASSES,
                             (h // 64 + 1, w // 64 + 1)).repeat(64, 0).repeat(64, 1)[:h, :w]
        pan = stuff.astype(np.int64) + 1
        sem = stuff.astype(np.uint8)
        segs = [{"id": int(c) + 1, "category_id": int(c), "iscrowd": 0} for c in np.unique(stuff)]
        yy, xx = np.ogrid[:h, :w]
        for k in range(int(rng.integers(4, 13))):
            c = int(rng.choice(COCO_THINGS))
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry, rx = rng.uniform(h / 20, h / 5), rng.uniform(w / 20, w / 5)
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
            pan[inside], sem[inside] = (c + 1) * 1000 + k, c
            segs.append({"id": (c + 1) * 1000 + k, "category_id": c, "iscrowd": 0})
        pan[h - h // 16:], sem[h - h // 16:] = 0, 255
        present = set(np.unique(pan).tolist())
        segs = [s for s in segs if s["id"] in present]
        name = f"smoke_coco/{i:02d}_{h}x{w}"
        out.append(({"file_name": name + ".jpg", "pan_seg_file_name": name + "_pan.png",
                     "image_id": name, "height": h, "width": w, "segments_info": segs},
                    img, pan, sem))
    return out


def coco_panoptic_batches(pairs, batch, slots, dev):
    """Training batches of `batch` pairs each (all of the LSJ canvas' size):
    one target per segment (its mask and class) in `slots` padded slots,
    and the semantic map the GT-edge oracle reads."""
    import numpy as np
    import torch

    for start in range(0, len(pairs) - batch + 1, batch):
        part = pairs[start:start + batch]
        h, w = part[0][1].shape[:2]
        masks = np.zeros((batch, slots, h, w), np.uint8)
        labels = np.zeros((batch, slots), np.int64)
        valid = np.zeros((batch, slots), bool)
        for i, (d, _, pan, _) in enumerate(part):
            for j, seg in enumerate(d["segments_info"][:slots]):
                masks[i, j] = pan == seg["id"]
                labels[i, j], valid[i, j] = seg["category_id"], True
        yield {"image": torch.from_numpy(np.stack([p[1] for p in part])).to(dev),
               "masks": torch.from_numpy(masks).to(dev),
               "labels": torch.from_numpy(labels).to(dev),
               "valid": torch.from_numpy(valid).to(dev),
               "sem_seg_map": torch.from_numpy(np.stack([p[3] for p in part])).to(dev)}


def module_dtypes(model, fn, probe=None):
    """fn() with a forward hook on each of the model's leaf modules that hold
    parameters -> (fn's result, {module name: the dtypes of its float
    outputs}, the output of the module named `probe`)."""
    import torch

    dtypes, hooked, handles = {}, {}, []

    def floats(o):
        if torch.is_tensor(o):
            return {str(o.dtype).replace("torch.", "")} if o.is_floating_point() else set()
        if isinstance(o, dict):
            o = list(o.values())
        return set().union(*map(floats, o)) if isinstance(o, (tuple, list)) else set()

    for name, m in model.named_modules():
        if name == probe:
            handles.append(m.register_forward_hook(lambda mod, i, o: hooked.setdefault("o", o)))
        if next(m.children(), None) is None and next(m.parameters(False), None) is not None:
            handles.append(m.register_forward_hook(
                lambda mod, i, o, name=name: dtypes.setdefault(name, set()).update(floats(o))))
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    return out, dtypes, hooked.get("o")


def dtype_census(model):
    """{"parameters" / "gradients" / "buffers": the dtypes of the model's
    parameters, of their gradients and of its float buffers}."""
    census = {}
    for kind, tensors in (("parameters", model.parameters()),
                          ("gradients", (p.grad for p in model.parameters()
                                         if p.grad is not None)),
                          ("buffers", (b for b in model.buffers() if b.is_floating_point()))):
        for t in tensors:
            census.setdefault(kind, set()).add(str(t.dtype).replace("torch.", ""))
    return census


def amp_phase(dev, smi, gen, counters, opts=(), size=AMP_SIZE, batch=AMP_BATCH, steps=AMP_STEPS,
              eval_sizes=AMP_EVAL_SIZES, out_dir="chiprun_out"):
    """Phase 19: the published COCO-panoptic MaskFiner-UpDown-Tiny, which
    turns SOLVER.AMP.ENABLED on, from a Trainer (seeded random weights) at
    size x size: K1, K3 and K9 on a batch-`batch` AMP forward's operands
    (the fp32 casts of the bf16 layers' tensors) against their plain
    versions; the AMP forward's dtypes on the card (AMP_BF16_SHARE_MIN of
    the parameterised leaf modules bf16, the first stage's features and
    positions AMP_STAGE1_DTYPES; every module fp32 with AMP off); the AMP
    forward through the kernels against the plain versions
    replaying its choices (AMP_FORWARD_RTOL, the choice floors as phase 17
    holds them); K2, K4, K10, K12 and K13 on a real AMP step's operands;
    `steps` AMP steps on COCO-panoptic-shaped batches (133 classes, 80
    things), each replayed through the plain versions (AMP_LOSS_RTOL,
    AMP_GROUP_NORM_RTOL) and then taken by the Trainer (launches, fp32
    masters, gradients, AdamW moments and BatchNorm statistics); the same
    steps in fp32 from the same weights, the worst loss term of the AMP
    run between AMP_FP32_MIN and AMP_FP32_BUDGET of the fp32 run's; test() on `eval_sizes`
    images with panoptic inference and PQ.  ms, device busy and peak GiB
    of the fp32 and the AMP forward and step side by side.  Writes the
    record to out_dir/phase19.json.  Returns ({kernel: {path: record}},
    {counter: launches of the phase's runs through the kernels})."""
    import copy
    import os
    import tempfile

    import torch
    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.layers import set_dropout_generator
    from autofocusformermod_torch.models.maskformer import init_random_weights
    from autofocusformermod_torch.models.registry import build_model
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.parallel import precision
    from autofocusformermod_torch.tools.l2_rate import l2_read_rate

    paths, total = {}, dict.fromkeys(counters, 0)
    record = {"card": smi, "preset": AMP_PRESET, "size": size, "batch": batch}

    def reset():
        for c in counters.values():
            c.launches = 0

    def add(got):
        for name, k in got.items():
            total[name] += k

    def expect(label, got, want):
        want = {n: want.get(n, 0) for n in counters}
        if got != want:
            raise SystemExit(f"{label}: launched {got}, expected {want}")

    def draw(i):
        return device_draw(torch.Generator(device=dev).manual_seed(SEED + i))

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30

    train_pairs = coco_panoptic_pairs([(size, size)] * (batch * steps), SEED + 19)
    test_pairs = coco_panoptic_pairs(eval_sizes, SEED + 20)
    meta = {"evaluator_type": "coco_panoptic_seg", "ignore_label": 255,
            "thing_dataset_id_to_contiguous_id": {i: i for i in COCO_THINGS}}
    module = "autofocusformermod_torch.data.mapper_panoptic_instance"
    files = {d["file_name"]: img for d, img, _, _ in train_pairs + test_pairs}
    pans = {d["pan_seg_file_name"]: pan for d, _, pan, _ in train_pairs + test_pairs}
    segs = [len(d["segments_info"]) for d, *_ in train_pairs + test_pairs]
    log(f"  data: {len(train_pairs)} COCO-panoptic-shaped {size}x{size} training pairs and "
        f"{len(test_pairs)} test pairs {list(eval_sizes)}, {min(segs)}-{max(segs)} segments "
        f"each ({COCO_PANOPTIC_CLASSES} classes, {len(COCO_THINGS)} things)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="amp_") as tmp, \
            in_memory_files({name: ([d for d, *_ in test_pairs], meta) for name in AMP_NAMES},
                            {(module, "read_image"): files, (module, "read_pan_seg"): pans}), \
            watch_predict(counters) as watch:
        cfg = PRESETS[AMP_PRESET]()
        cfg.merge_from_list([*opts, "SOLVER.IMS_PER_BATCH", str(batch), "OUTPUT_DIR", tmp,
                             "DATASETS.TRAIN", f"('{AMP_NAMES[0]}',)",
                             "DATASETS.TEST", f"('{AMP_NAMES[1]}',)"])
        trainer = Trainer(cfg, dev)
        model = trainer.model
        init_random_weights(model, torch.Generator().manual_seed(SEED))
        initial = copy.deepcopy(model.state_dict())
        if model.compute_dtype != torch.bfloat16 or not precision.uses_amp(model):
            raise SystemExit(f"{AMP_PRESET}: the model computes in {model.compute_dtype}")
        n_params = sum(p.numel() for p in model.parameters())
        fwd_want = family_launches(cfg, False, (size, size))
        step_want = family_launches(cfg, True, (size, size))
        images = torch.randint(0, 256, (batch, size, size, 3), dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(SEED + 3)).to(dev)
        model.eval()
        text, fields = updown_stream(cfg, model, images)
        log(f"  {AMP_PRESET}: {cfg.MODEL.META_ARCHITECTURE} over {cfg.MODEL.BACKBONE.NAME}, "
            f"{n_params / 1e6:.2f}M parameters, AMP (bf16 compute, fp32 masters); the token "
            f"stream at {size}x{size}: {text}; launches expected per forward {fwd_want}, per "
            f"step {step_want}")
        record.update(parameters=n_params, **fields)

        # K1, K3 and K9 on the AMP forward's operands
        ops = path_forward_operands(model, images)
        dtypes = {str(a.dtype) for calls in ops.values() for call in calls
                  for a in call if torch.is_tensor(a) and a.is_floating_point()}
        if dtypes != {"torch.float32"}:
            raise SystemExit(f"{AMP_PRESET}: the kernels' float operands under AMP are {dtypes}")
        paths["local_attn"] = {"amp": check_local_attn_calls("amp", ops["local_attn"])}
        paths["msdetrpc"] = {"amp": check_msdetrpc("amp", ops["msdetrpc"], l2_read_rate())}
        paths["knn"] = {"amp": check_knn("amp", ops["knn"])}
        del ops
        torch.cuda.empty_cache()

        # the AMP forward computes in bf16 on the card: every parameterised
        # leaf module, and the first backbone stage's features beside fp32
        # positions
        with torch.no_grad():
            _, dtypes, stage1 = module_dtypes(model, lambda: precision.apply(model, images),
                                              "backbone.backbones.0")
        stage1 = stage1[0] if isinstance(stage1, tuple) else stage1
        finest = min(k for k in stage1 if k[:3] == "res" and k[3:].isdigit())
        computed = {n: d for n, d in dtypes.items() if d}
        bf16 = sum(d == {"bfloat16"} for d in computed.values())
        share = bf16 / max(len(computed), 1)
        stage1_dtypes = (str(stage1[finest].dtype), str(stage1[finest + "_pos"].dtype))
        log(f"  the AMP forward on the card: {bf16} of {len(computed)} parameterised leaf modules "
            f"compute in bf16 (floor {AMP_BF16_SHARE_MIN}), the others "
            f"{ {n: sorted(d) for n, d in computed.items() if d != {'bfloat16'}} }; the first "
            f"backbone stage's {finest} {stage1_dtypes[0]}, its positions {stage1_dtypes[1]}")
        record["amp_bf16_modules"] = [bf16, len(computed)]
        if share < AMP_BF16_SHARE_MIN or AMP_STAGE1_DTYPES not in (None, stage1_dtypes):
            raise SystemExit(f"{AMP_PRESET}: under AMP {bf16} of {len(computed)} modules compute "
                             f"in bf16, the first stage's features and positions {stage1_dtypes}")
        del dtypes, stage1

        # the AMP forward through the kernels, then the plain versions replaying its choices
        book = {}
        with torch.no_grad():
            reset()
            with same_choices(book, record=True):
                out, first_ms, got = counted_call(counters,
                                                  lambda: precision.apply(model, images))
            expect(f"{AMP_PRESET} AMP forward", got, fwd_want)
            add(got)
            with same_choices(book, record=False), plain_versions():
                ref = precision.apply(model, images)
            queries = cfg.MODEL.MASK_FINER.NUM_OBJECT_QUERIES
            if tuple(out["pred_masks"].shape) != (batch, queries, size // 4, size // 4) or \
                    out["pred_logits"].shape[-1] != COCO_PANOPTIC_CLASSES + 1:
                raise SystemExit(f"{AMP_PRESET}: outputs {tuple(out['pred_logits'].shape)}, "
                                 f"{tuple(out['pred_masks'].shape)}")
            if {str(v.dtype) for v in (out["pred_logits"], out["pred_masks"])} != {"torch.float32"}:
                raise SystemExit(f"{AMP_PRESET}: the AMP outputs are not fp32")
            record["forward_worst_rel"] = check_head_outputs(
                f"{AMP_PRESET} AMP forward", out, ref, book, rtol=AMP_FORWARD_RTOL,
                mean_rtol=AMP_FORWARD_MEAN_RTOL, floors=AMP_CHOICE_AGREE_MIN)
            del out, ref, book

            # the same forward in fp32 (the model built with AMP off, the same weights)
            cfg32 = copy.deepcopy(cfg)
            cfg32.SOLVER.AMP.ENABLED = False
            model32 = build_model(cfg32).to(dev)
            model32.load_state_dict(initial)
            model32.eval()
            _, dtypes32, _ = module_dtypes(model32, lambda: precision.apply(model32, images))
            if set().union(*dtypes32.values()) != {"float32"}:
                raise SystemExit(f"{AMP_PRESET} with AMP off computes in "
                                 f"{set().union(*dtypes32.values())}")

            def forward_ms(m):
                times, peaks = [], []
                for _ in range(4):
                    torch.cuda.reset_peak_memory_stats()
                    _, ms, _ = counted_call(counters, lambda: precision.apply(m, images))
                    times.append(ms)
                    peaks.append(peak_gib())
                busy, rows = device_busy(lambda: precision.apply(m, images), runs=2)
                return {"ms": statistics.median(times[1:]), "busy_ms": busy, "rows": rows,
                        "peak_gib": max(peaks)}

            reset()
            fwd = {"amp": forward_ms(model), "fp32": forward_ms(model32)}
            add({name: c.launches for name, c in counters.items()})
        for k, r in fwd.items():
            log(f"  {AMP_PRESET} {k} forward at batch {batch} (median of 3 after one): "
                f"{r['ms']:.2f} ms, device busy {r['busy_ms']:.2f} ms in {r['rows']:.0f} rows "
                f"({r['busy_ms'] / r['ms']:.0%}), peak {r['peak_gib']:.2f} GiB ({smi})")
        record["forward"] = {"first_ms": first_ms, "launches": got, **fwd}
        del images
        torch.cuda.empty_cache()

        # the kernels on a real AMP step's operands, then the steps
        model.train()
        model32.train()
        batches = list(coco_panoptic_batches(train_pairs, batch, cfg.TPU.MAX_GT_INSTANCES, dev))
        hold_grid_step_operands(f"{AMP_PRESET}_amp_step", model, cfg, batches[0], gen, paths,
                                local_attn=True)
        step32 = TrainStep(model32, cfg32)
        n_out = cfg.MODEL.MASK_FINER.DEC_LAYERS[-1]
        record["steps"] = []
        drop_path = trainer.generators["dropout"]
        gen32 = torch.Generator(device=dev)
        set_dropout_generator(model32, gen32)
        for i, b in enumerate(batches):
            used, r_ms, p_ms, r_peak, p_peak = replay_step(
                f"{AMP_PRESET} AMP step {i + 1}", model, cfg, b, lambda: draw(i + 1), True,
                AMP_LOSS_RTOL, AMP_GROUP_NORM_RTOL, AMP_CHOICE_AGREE_MIN, AMP_NEAR_TIE_AGREE_MIN)
            # the AMP step through the Trainer, then the fp32 step replaying its choices
            drop_path.manual_seed(SEED + 50 + i)
            gen32.manual_seed(SEED + 50 + i)
            book = {}
            reset()
            torch.cuda.reset_peak_memory_stats()
            with same_choices(book, record=True):
                metrics, ms, got = counted_call(counters, lambda: trainer.step_fn(b, draw(i + 1)))
            add(got)
            peak = peak_gib()
            expect(f"{AMP_PRESET} AMP step {i + 1}", got, step_want)
            census = dtype_census(model)
            moments = {str(v.dtype) for st in trainer.step_fn.optimizer.state.values()
                       for v in st.values() if torch.is_tensor(v) and v.is_floating_point()}
            if any(d != {"float32"} for d in census.values()) or moments != {"torch.float32"}:
                raise SystemExit(f"{AMP_PRESET} AMP step {i + 1}: dtypes {census}, AdamW "
                                 f"moments {moments}")
            torch.cuda.reset_peak_memory_stats()
            with same_choices(book, record=False):
                metrics32, ms32, _ = counted_call({}, lambda: step32(b, draw(i + 1)))
            peak32 = peak_gib()
            # logged: how many of the fp32 run's own choices bf16 rounding flips
            same_choices.check(f"{AMP_PRESET} fp32 step {i + 1} replaying the AMP step's",
                               book, by_scores=tuple({k for k, *_ in same_choices.KINDS}))
            terms = {k: (metrics[k].item(), metrics32[k].item()) for k in metrics32
                     if k != "grad_norm"}
            rel = {k: abs(a - f) / max(abs(f), 1e-3) for k, (a, f) in terms.items()}
            worst = max(rel, key=rel.get)
            log(f"  {AMP_PRESET} step {i + 1} at batch {batch}: AMP {ms:.1f} ms (peak {peak:.2f} "
                f"GiB), fp32 {ms32:.1f} ms (peak {peak32:.2f} GiB); total loss AMP "
                f"{terms['total_loss'][0]:.5f} fp32 {terms['total_loss'][1]:.5f}, "
                f"loss_upsampling {terms['loss_upsampling'][0]:.5g} / "
                f"{terms['loss_upsampling'][1]:.5g}, grad_norm {metrics['grad_norm'].item():.4f} / "
                f"{metrics32['grad_norm'].item():.4f}; {len(terms)} terms, worst AMP/fp32 "
                f"{worst} {rel[worst]:.3e} (limits {AMP_FP32_MIN} to {AMP_FP32_BUDGET}); masters, gradients, "
                f"buffers {census}, AdamW moments {sorted(moments)}")
            if len(metrics) != 3 + 3 * n_out or not all(
                    torch.isfinite(v).all() for v in metrics.values()) \
                    or not metrics["loss_upsampling"].item() > 0:
                raise SystemExit(f"{AMP_PRESET} AMP step {i + 1}: {len(metrics)} metrics, "
                                 f"non-finite or loss_upsampling {metrics['loss_upsampling']}")
            if not AMP_FP32_MIN <= rel[worst] <= AMP_FP32_BUDGET:
                raise SystemExit(f"{AMP_PRESET} step {i + 1}: {worst} of the AMP run "
                                 f"{terms[worst][0]} against fp32 {terms[worst][1]} (rel "
                                 f"{rel[worst]}, limits {AMP_FP32_MIN} to {AMP_FP32_BUDGET})")
            record["steps"].append({"amp_ms": ms, "amp_peak_gib": peak, "fp32_ms": ms32,
                                    "fp32_peak_gib": peak32, "plain_ms": p_ms,
                                    "plain_peak_gib": p_peak, "replayed_batch": used,
                                    "terms": terms, "worst_amp_fp32": [worst, rel[worst]],
                                    "launches": got})
            del book

        def busy_step(step_fn):
            def one():
                step_fn(batches[0], draw(0))
                torch.cuda.synchronize()
            return device_busy(one, runs=1)

        reset()
        busy, rows = busy_step(trainer.step_fn)
        busy32, rows32 = busy_step(step32)
        add({name: c.launches for name, c in counters.items()})
        amp_ms = record["steps"][-1]["amp_ms"]
        fp32_ms = record["steps"][-1]["fp32_ms"]
        log(f"  {AMP_PRESET} step {steps} at batch {batch}: AMP {amp_ms:.1f} ms, device busy "
            f"{busy:.1f} ms in {rows:.0f} rows ({busy / amp_ms:.0%}); fp32 {fp32_ms:.1f} ms, "
            f"busy {busy32:.1f} ms in {rows32:.0f} rows ({busy32 / fp32_ms:.0%}) ({smi})")
        record["step_busy_ms"] = {"amp": busy, "fp32": busy32}
        del batches, step32, model32
        torch.cuda.empty_cache()

        # test(): panoptic inference and PQ on the AMP view
        reset()
        t0 = time.time()
        results = trainer.test()
        torch.cuda.synchronize()
        dt = time.time() - t0
        add({name: c.launches for name, c in counters.items()})
        pq = results[AMP_NAMES[1]]
        log(f"  {AMP_PRESET} test() on {len(watch.images)} images: {dt:.2f} s, "
            + ", ".join(f"{k} {v:.4f}" for k, v in pq.items())
            + f"; ms per image by padded input {ms_by_size(watch.images)}; launches per image "
            f"{[rec['launches'] for rec in watch.images]} ({smi})")
        if len(watch.images) != len(eval_sizes) or not all(math.isfinite(v) for v in pq.values()) \
                or not 0.0 <= pq["PQ"] <= 100.0:
            raise SystemExit(f"{AMP_PRESET} test(): {len(watch.images)} images, {pq}")
        for rec in watch.images:
            expect(f"{AMP_PRESET} test() image {rec['input']}", rec["launches"],
                   family_launches(cfg, False, rec["input"]))
        record["test"] = {"seconds": dt, **pq, "ms_by_input": ms_by_size(watch.images)}
        del trainer, model
        torch.cuda.empty_cache()
    record["kernels"] = paths
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "phase19.json"), "a") as f:
        f.write(json.dumps(record, default=str) + "\n")
    return paths, total


# phase 20: published yamls read by the port's own yaml reader on the card
# and driven through train_net --config-file at their published widths and
# depths: (label, yaml, training batch (the yaml's batch cut to what one card
# holds), forward batch, demo image (h, w), whether the kernels are held on
# the operands of a real forward and step: AFF-Base's 144-slot
# neighbourhood is the one shape of K1 and K2 no other phase gives them)
YAML_RUNS = (
    ("coco_panoptic_maskfiner_R50", "configs/coco/panoptic-segmentation/maskfiner_R50_bs16_50ep.yaml",
     2, 1, (800, 1200), False),
    ("maskfiner_large",
     "configs/ade20k/semantic-segmentation/maskfiner/maskfiner_large_bs32_80k.yaml", 4, 2,
     (512, 683), False),
    ("cityscapes_aff_base_384",
     "configs/cityscapes/panoptic-segmentation/aff/maskformer2_aff_base_384_bs16_90k.yaml", 2, 1,
     (1024, 2048), True),
    ("cityscapes_updown_base_sw",
     "configs/cityscapes/semantic-segmentation/maskfiner/maskfiner_updown_base_sw_bs16_90k.yaml",
     2, 1, (1024, 2048), False),
)
YAML_STEPS = 2
# the parameter counts the CPU tests hold to JAX's (tests/test_torch_config_builds.py)
YAML_PARAMS = {"coco_panoptic_maskfiner_R50": 41_665_184, "maskfiner_large": 94_428_140,
               "cityscapes_aff_base_384": 94_077_733, "cityscapes_updown_base_sw": 111_036_723}
# the one image the sliding-window model's test() scores, windows included
YAML_SW_SIZE = (1024, 2048)


def yaml_launches(cfg, step: bool, hw) -> dict:
    """Every kernel's launches in one forward or training step of a yaml's
    model at (h, w): the MaskFiner cascade's (maskfiner_launches, a square
    canvas), the OracleTeacher cascades' (family_launches), else AFF +
    Mask2Former's (a local attention per block of a stage of more tokens
    than its neighbourhood, an msdetrpc per encoder layer and level, 10 knn
    less one per stage that attends globally: the clusters, the merges, the
    decoder's tables and the FPN's upsample; a step adds the backwards and
    the criterion's K10, K13 and the ranking's read at the masks' quarter
    size)."""
    from autofocusformermod_torch.losses import point_sample as sampler
    from autofocusformermod_torch.models.registry import meta_architecture
    from autofocusformermod_torch.ops.point_sample import point_sample_nearest_rows_supported

    arch = meta_architecture(cfg)
    if arch == "MaskFiner":
        if step and hw[0] != hw[1]:
            raise ValueError(f"a MaskFiner step's launches at a square canvas, not {hw}")
        return maskfiner_step_launches(cfg, hw[0]) if step else maskfiner_launches(cfg)
    if arch.startswith("MaskFiner"):
        return family_launches(cfg, step, hw)
    a = cfg.MODEL.AFF
    n, clustered = (hw[0] // 4) * (hw[1] // 4), []
    for i in range(len(a.DEPTHS)):
        if n > a.NBHD_SIZE[i]:                  # else the stage attends globally
            clustered.append(i)
        n = int(n * a.DS_RATE)
    blocks = sum(a.DEPTHS[i] for i in clustered)
    layers = cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS * 3
    fwd = {"local_attn": blocks, "msdetrpc": layers,
           "knn": 10 - (len(a.DEPTHS) - len(clustered))}
    if not step:
        return fwd
    mf = cfg.MODEL.MASK_FORMER
    rows = int(sampler.STRATIFY_RANKING and point_sample_nearest_rows_supported(
        hw[0] // 4, hw[1] // 4, int(mf.TRAIN_NUM_POINTS * mf.OVERSAMPLE_RATIO)))
    return {**fwd, "local_attn_bwd": blocks, "msdetrpc_bwd": layers, "point_sample": 2,
            "point_sample_bwd": 1, "point_sample_nearest": 1 - rows,
            "point_sample_nearest_rows": rows, "lapjv": 1}


def yaml_phase(dev, smi, gen, counters, runs=YAML_RUNS, steps=YAML_STEPS, params=YAML_PARAMS,
               sw_size=YAML_SW_SIZE, out_dir="chiprun_out"):
    """Phase 20: each of `runs` read by the port's yaml reader (PyYAML is
    neither imported nor needed), then `python -m autofocusformermod_torch.
    train_net --config-file <yaml> --synthetic --max-iter <steps>` in this
    process at the yaml's published width, depth and training size (batch
    cut as listed; seeded weights, synthetic label maps): the steps'
    launches against yaml_launches, their ms and peak GiB from the run's
    metrics.jsonl; the trained model's eval forward through the kernels and
    through the plain versions replaying its choices (check_head_outputs;
    an AMP model at AMP_FORWARD_RTOL); where the run asks for it, K1, K3 and
    K9 on the operands of one image's forward and K2, K4, K10, the
    ranking's read and K13 on those of a real step, each against its plain
    version (hold_forward_operands, hold_grid_step_operands); one more
    step's device busy time;
    the demo's run_on_image on one image of the yaml's test size (launches
    of one forward at its padded size); the sliding-window model's test()
    on one sw_size image (launches per window); the analysis tool's
    parameter count against `params`.  Writes out_dir/phase20.json.
    Returns ({kernel: {path: record}} of the holds, {counter: launches of
    the phase's runs through the kernels})."""
    import importlib.util
    import tempfile

    import numpy as np
    import torch
    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.config import published_cfg, train_image_size
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from autofocusformermod_torch.demo import VisualizationDemo
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.inference import sliding_window_grid
    from autofocusformermod_torch.models.registry import meta_architecture
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.ops.dispatch import plain_versions
    from autofocusformermod_torch.parallel import precision
    from autofocusformermod_torch.tools import analyze_model

    paths, total, records = {}, dict.fromkeys(counters, 0), {"card": smi}
    device_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    pyyaml = importlib.util.find_spec("yaml") is not None
    log(f"  PyYAML {'is' if pyyaml else 'is not'} installed; the yamls are read by "
        "autofocusformermod_torch/config/yaml_reader.py")

    def reset():
        for c in counters.values():
            c.launches = 0

    def expect(label, got, want):
        want = {n: want.get(n, 0) for n in counters}
        if got != want:
            raise SystemExit(f"{label}: launched {got}, expected {want}")

    def add(got):
        for name, k in got.items():
            total[name] += k

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pairs = eval_dataset((tuple(sw_size),))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="yamls_") as tmp, \
            semantic_files(pairs), watch_eval(counters) as watch:
        for label, path, batch, fwd_batch, demo_hw, hold in runs:
            t0 = time.time()
            cfg = published_cfg(path)
            if sys.modules.get("yaml") is not None:
                raise SystemExit(f"{label}: reading {path} imported PyYAML")
            size = train_image_size(cfg)
            arch, amp = meta_architecture(cfg), bool(cfg.SOLVER.AMP.ENABLED)
            step_want = yaml_launches(cfg, True, size)
            rec = {"yaml": path, "arch": arch, "backbone": cfg.MODEL.BACKBONE.NAME, "amp": amp,
                   "train_size": size, "batch": batch, "published_batch": cfg.SOLVER.IMS_PER_BATCH,
                   "forward_batch": fwd_batch}
            log(f"  {label}: {path} ({arch} over {cfg.MODEL.BACKBONE.NAME}, AMP {amp}), read "
                f"without PyYAML; training at {size[0]}x{size[1]}, batch {batch} (the yaml's "
                f"{cfg.SOLVER.IMS_PER_BATCH}); launches expected per step {step_want}")
            out = os.path.join(tmp, label)
            reset()
            torch.cuda.reset_peak_memory_stats()
            trainer, run_ms, got = counted_call(counters, lambda: train_net.main([
                "--config-file", path, "--synthetic", "--max-iter", str(steps), *device_args,
                "SOLVER.IMS_PER_BATCH", str(batch), "OUTPUT_DIR", out, "TEST.EVAL_PERIOD", "0",
                "DATASETS.TEST", f"('{EVAL_NAMES[1]}',)"]))
            add(got)
            expect(f"{label} train_net", got, {k: v * steps for k, v in step_want.items()})
            with open(os.path.join(out, "metrics.jsonl")) as f:
                logged = [json.loads(line) for line in f]
            if [m["step"] for m in logged] != list(range(1, steps + 1)) or not all(
                    math.isfinite(m["total_loss"]) for m in logged):
                raise SystemExit(f"{label}: the run logged "
                                 f"{[(m['step'], m['total_loss']) for m in logged]}")
            cfg, model = trainer.cfg, trainer.model
            n_params = sum(p.numel() for p in model.parameters())
            rec.update(parameters=n_params, run_ms=run_ms, launches_per_run=got, steps=[
                {"ms": m["seconds"] * 1e3, "peak_gib": m.get("peak_bytes_in_use", 0) / 2 ** 30,
                 "total_loss": m["total_loss"]} for m in logged])
            log(f"  {label}: {n_params / 1e6:.2f}M parameters; train_net ({steps} steps, "
                f"checkpoint) {run_ms / 1e3:.1f} s; steps "
                + ", ".join(f"{s['ms']:.1f} ms (peak {s['peak_gib']:.2f} GiB, loss "
                            f"{s['total_loss']:.4f})" for s in rec["steps"]) + f" ({smi})")
            if n_params != params[label]:
                raise SystemExit(f"{label}: {n_params} parameters, the CPU tests hold "
                                 f"{params[label]}")

            # the trained model's forward through the kernels and the plain versions
            model.eval()
            images = torch.randint(0, 256, (fwd_batch, *size, 3), dtype=torch.uint8,
                                   generator=torch.Generator().manual_seed(SEED + 7)).to(dev)
            fwd_want = yaml_launches(cfg, False, size)
            book = {}
            with torch.no_grad():
                reset()
                with same_choices(book, record=True, near_ties=amp):
                    out_k, fwd_ms, got = counted_call(counters,
                                                      lambda: precision.apply(model, images))
                expect(f"{label} forward", got, fwd_want)
                add(got)
                with same_choices(book, record=False), plain_versions():
                    ref = precision.apply(model, images)
            rec["forward"] = {"ms": fwd_ms, "launches": got, "worst_rel": check_head_outputs(
                f"{label} forward", out_k, ref, book, rtol=AMP_FORWARD_RTOL if amp else FORWARD_RTOL,
                mean_rtol=AMP_FORWARD_MEAN_RTOL if amp else None,
                floors=AMP_CHOICE_AGREE_MIN if amp else None,
                near_tie_floors=AMP_NEAR_TIE_AGREE_MIN if amp else None)}
            log(f"  {label} batch-{fwd_batch} forward through the kernels {fwd_ms:.1f} ms "
                f"(first call), held to the plain versions (choices replayed)")
            del out_k, ref, book
            torch.cuda.empty_cache()
            batches = synthetic_batches(cfg, dev, steps)
            if hold:
                hold_forward_operands(f"{label}_forward", model, images[:1], paths)
                model.train()
                hold_grid_step_operands(f"{label}_step", model, cfg, next(batches), gen, paths,
                                        local_attn=True)
                if f"{label}_step" not in paths.get("local_attn_bwd", {}):
                    raise SystemExit(f"{label}: the step made no local_attn backward call")
            del images
            torch.cuda.empty_cache()

            # one more step's device busy time
            model.train()

            def one_step():
                trainer.step_fn(next(batches), device_draw(
                    torch.Generator(device=dev).manual_seed(SEED + 11)))
                torch.cuda.synchronize()

            reset()
            busy, rows = device_busy(one_step, runs=1)
            add({name: c.launches for name, c in counters.items()})
            rec["step_busy_ms"], rec["step_rows"] = busy, rows
            last = rec["steps"][-1]["ms"]
            log(f"  {label} a step at batch {batch}: device busy {busy:.2f} ms in {rows:.0f} "
                f"rows ({busy / last:.0%} of step {steps}'s {last:.1f} ms) ({smi})")
            del batches
            torch.cuda.empty_cache()

            # the demo on one image of the yaml's test size
            demo = VisualizationDemo(cfg, model=model)
            rng = np.random.default_rng(SEED + 13)
            h, w = demo_hw
            coarse = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.uint8)
            img = np.ascontiguousarray(coarse.repeat(16, 0).repeat(16, 1)[:h, :w])
            reset()
            pred, demo_ms, got = counted_call(counters, lambda: demo.run_on_image(img))
            add(got)
            scale = min(demo.min_size / min(h, w), demo.max_size / max(h, w))
            nh, nw = int(round(h * scale)), int(round(w * scale))
            padded = (-(-nh // demo.div) * demo.div, -(-nw // demo.div) * demo.div)
            expect(f"{label} demo", got, yaml_launches(cfg, False, padded))
            if pred.shape != (h, w) or pred.min() < 0 or pred.max() >= demo.nc:
                raise SystemExit(f"{label} demo: labels {pred.shape} in [{pred.min()}, "
                                 f"{pred.max()}] for {demo.nc} classes")
            rec["demo"] = {"image": [h, w], "padded": list(padded), "ms": demo_ms,
                           "classes_seen": int(len(np.unique(pred))), "launches": got}
            log(f"  {label} demo.run_on_image on a {h}x{w} image (padded {padded}): "
                f"{demo_ms:.1f} ms (first call), {len(np.unique(pred))} classes")
            del demo

            if arch.endswith("SW"):
                start = len(watch.images)
                reset()
                t1 = time.time()
                results = trainer.test()
                torch.cuda.synchronize()
                dt = time.time() - t1
                add({name: c.launches for name, c in counters.items()})
                recs = watch.images[start:]
                crop, stride = cfg.TEST.SW_CROP_SIZE, cfg.TEST.SW_STRIDE
                windows = len(sliding_window_grid(sw_size, crop, stride))
                miou = results[EVAL_NAMES[1]]["mIoU"]
                if len(recs) != 1 or not math.isfinite(miou):
                    raise SystemExit(f"{label} test(): {len(recs)} images, mIoU {miou}")
                per_window = yaml_launches(cfg, False, tuple(crop))
                expect(f"{label} test() in {windows} windows", recs[0]["launches"],
                       {k: v * windows for k, v in per_window.items()})
                rec["test"] = {"image": list(sw_size), "windows": windows, "seconds": dt,
                               "mIoU": miou, "launches": recs[0]["launches"]}
                log(f"  {label} test() on one {sw_size[0]}x{sw_size[1]} image in {windows} "
                    f"windows of {list(crop)}: {dt:.2f} s, mIoU {miou:.4f} ({smi})")

            analysed = analyze_model.main(["--config-file", path, "--tasks", "param",
                                           *device_args])
            if analysed["parameters"] != params[label]:
                raise SystemExit(f"{label}: the analysis counts {analysed['parameters']} "
                                 f"parameters, the CPU tests {params[label]}")
            rec["seconds"] = time.time() - t0
            log(f"  {label} took {rec['seconds']:.1f} s")
            records[label] = rec
            del trainer, model
            torch.cuda.empty_cache()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "phase20.json"), "w") as f:
        json.dump({**records, "holds": paths}, f, indent=1, default=str)
    return paths, total


DIST_PRESET = "aff_mini"
DIST_RANKS, DIST_LOCAL_BATCH, DIST_STEPS = 2, 4, 2
# each rank's own limit: the spawn, the model's build and two steps take
# ~1 min on the card; a hung collective fails the run after this
DIST_JOIN_S = 420
DIST_EVAL_SIZES = EVAL_SIZES[:2]
DIST_PER_STEP = {"local_attn": 12, "local_attn_bwd": 12, "msdetrpc": 18, "msdetrpc_bwd": 18,
                 "point_sample": 2, "point_sample_bwd": 1, "lapjv": 1, "knn": 10,
                 "point_sample_nearest": 0, "point_sample_nearest_rows": 1}


def dist_cfg(out_dir, opts=(), batch=DIST_RANKS * DIST_LOCAL_BATCH):
    """The published AFF-Mini preset at its full width, 512x512 crops, the
    global batch `batch`, checkpoints under `out_dir`; `opts` override
    (a CPU rehearsal's tiny sizes)."""
    from autofocusformermod_torch.config import PRESETS

    cfg = PRESETS[DIST_PRESET]()
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", str(batch), "OUTPUT_DIR", out_dir] + list(opts))
    return cfg


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0


def _compact(t):
    """A recorded choice for a file: an expanded view as its base slice."""
    if t.dim() and 0 in t.stride():
        idx = tuple(slice(None) if s else slice(0, 1) for s in t.stride())
        return ("expanded", t[idx].contiguous().cpu(), tuple(t.shape))
    return t.cpu()


def _expand(rec, dev):
    if isinstance(rec, tuple) and rec and rec[0] == "expanded":
        return rec[1].to(dev).expand(rec[2])
    return rec.to(dev)


def shard_book(book, rank, world, groups, dev):
    """A one-process recording of the global batch's choices cut to rank
    `rank`'s rows: each choice of `groups` {kind: layer groups} laid out
    (groups, global batch, ...) along its first axis (the matches and ranked
    points of every decoder layer at once), the others batch-leading."""
    kinds = {(module, cls, name): kind for kind, module, cls, name in same_choices.KINDS}
    out = {}
    for where, calls in book.items():
        if where not in kinds:
            continue
        g = groups.get(kinds[where], 1)
        cut = []
        for rec in calls:
            t = _expand(rec, dev)
            per = t.shape[0] // g
            local = per // world
            cut.append(t.reshape(g, per, *t.shape[1:])[:, rank * local:(rank + 1) * local]
                       .reshape(g * local, *t.shape[1:]))
        out[where] = cut
    return out


def _dist_counters():
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.losses.lapjv import lapjv
    from autofocusformermod_torch.ops.local_attn import (sfc_cluster_attention,
                                                         sfc_cluster_attention_backward)
    from autofocusformermod_torch.ops.msdetrpc import msdetrpc_levels_s, msdetrpc_levels_s_backward
    from autofocusformermod_torch.ops.point_sample import (
        point_sample_backward, point_sample_bilinear, point_sample_nearest,
        point_sample_nearest_rows)

    return {"local_attn": sfc_cluster_attention,
            "local_attn_bwd": sfc_cluster_attention_backward,
            "msdetrpc": msdetrpc_levels_s, "msdetrpc_bwd": msdetrpc_levels_s_backward,
            "point_sample": point_sample_bilinear, "point_sample_bwd": point_sample_backward,
            "lapjv": lapjv, "knn": knn, "point_sample_nearest": point_sample_nearest,
            "point_sample_nearest_rows": point_sample_nearest_rows}


def dist_steps(trainer, batches, steps):
    """`steps` steps of the Trainer's TrainStep on the next batches: (every
    step's metrics as floats, ms per step between synchronisations)."""
    metrics, times = [], []
    for _ in range(steps):
        batch = next(batches)
        _sync(trainer.device)
        t0 = time.time()
        m = trainer.step_fn(batch, trainer.draw)
        metrics.append({k: float(v) for k, v in m.items()})
        times.append((time.time() - t0) * 1e3)
    return metrics, times


def dist_state(model):
    """(parameters, the stem BatchNorm's running statistics) on the CPU."""
    params = {n: p.detach().float().cpu().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().cpu().clone() for n, b in model.named_buffers() if "running" in n}
    return params, stats


def _dist_rank(device, tmp, opts):
    """Phase 21, one rank: the Trainer's two steps on this rank's rows of
    the global batches, replaying the one-process run's choices cut to its
    rows; results to <tmp>/rank<r>.pt."""
    import torch
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = mesh.process_index(), mesh.process_count()
    cfg = dist_cfg(os.path.join(tmp, "ranks"), opts)
    trainer = Trainer(cfg, device)
    book = torch.load(os.path.join(tmp, "book.pt"), weights_only=False)
    replay = shard_book(book, rank, world, {"ranked points": cfg.MODEL.MASK_FORMER.DEC_LAYERS,
                                            "matches": cfg.MODEL.MASK_FORMER.DEC_LAYERS}, device)
    counters = _dist_counters()
    for fn in counters.values():
        fn.launches = 0
    batches = synthetic_batches(cfg, device)
    with same_choices(replay, record=False):
        metrics, times = dist_steps(trainer, batches, DIST_STEPS)
    launches = {n: fn.launches for n, fn in counters.items()}
    params, stats = dist_state(trainer.model)
    # one step more without the replay: the step's time apart from it
    _, bare_ms = dist_steps(trainer, batches, 1)
    torch.save({"metrics": metrics, "ms": times, "bare_ms": bare_ms[0], "launches": launches,
                "params": params, "stats": stats, "agree": replay["agree"],
                "batch": trainer.process_count, "peak_gib": _peak_gib(device),
                "ddp": trainer.step_fn.ddp is not None},
               os.path.join(tmp, f"rank{rank}.pt"))


def distributed_phase(dev, smi, counters, opts=()):
    """Phase 21.  Two ranks on the one card (gloo: NCCL takes one rank a
    device) each take two AFF-Mini steps at batch 4 through Trainer /
    TrainStep (DistributedDataParallel, the global BatchNorm statistics,
    the global criterion), against one process's two steps on the global
    batch of 8 from the same generators; the ranks replay the one-process
    run's discrete choices cut to their rows.  Then train_net under a
    torchrun-style environment (WORLD_SIZE=1: an NCCL group, the DDP
    wrapper, the merge of the evaluators) for 2 steps and --eval-only on two
    images.  `opts` override the preset (a CPU rehearsal's tiny sizes).
    -> (record, {counter: launches of every run of the phase})."""
    import tempfile

    import numpy as np
    import torch
    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from autofocusformermod_torch.engine.optimizer import param_groups
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.parallel import mesh

    t_phase = time.time()
    total = {n: 0 for n in counters}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    record = {"card": smi}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="dist_") as tmp:
        # one process, the global batch of 8
        trainer = Trainer(dist_cfg(os.path.join(tmp, "one"), opts), dev)
        cfg = trainer.cfg
        initial, _ = dist_state(trainer.model)
        labels = {n: label for label, named in param_groups(trainer.model).items()
                  for n, _ in named}
        for fn in counters.values():
            fn.launches = 0
        book = {}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        batches = synthetic_batches(cfg, dev)
        with same_choices(book, record=True):
            one_metrics, one_ms = dist_steps(trainer, batches, DIST_STEPS)
        one_peak = _peak_gib(dev)
        one_launches = {n: fn.launches for n, fn in counters.items()}
        for n, v in one_launches.items():
            total[n] += v
        one_params, one_stats = dist_state(trainer.model)
        # one step more without the record: the step's time apart from it
        _, one_bare_ms = dist_steps(trainer, batches, 1)
        torch.save({where: [_compact(t) for t in calls] for where, calls in book.items()
                    if isinstance(where, tuple) and where[0] != "scores"},
                   os.path.join(tmp, "book.pt"))
        del trainer, book
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"  one process, batch {DIST_RANKS * DIST_LOCAL_BATCH}: ms per step "
            + ", ".join(f"{t:.1f}" for t in one_ms) + f" recording its choices, "
            f"{one_bare_ms[0]:.1f} a third step without (peak {one_peak:.2f} GiB, {smi}); total "
            "loss " + ", ".join(f"{m['total_loss']:.6f}" for m in one_metrics))

        # two ranks on cuda:0, gloo, batch 4 each
        t0 = time.time()
        mesh.launch(_dist_rank, DIST_RANKS, dist_url=f"file://{os.path.join(tmp, 'rendezvous')}",
                    args=(tmp, list(opts)), device_map=[str(dev)] * DIST_RANKS,
                    timeout_s=DIST_JOIN_S)
        t_ranks = time.time() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DIST_RANKS)]
        for r, got in enumerate(ranks):
            want = {n: v * DIST_STEPS for n, v in DIST_PER_STEP.items()}
            if dev.type == "cuda" and got["launches"] != want:
                raise SystemExit(f"rank {r} launched {got['launches']} in {DIST_STEPS} steps, "
                                 f"expected {want}")
            if not got["ddp"] or got["batch"] != DIST_RANKS:
                raise SystemExit(f"rank {r}: no DDP wrapper or a data axis of {got['batch']}")
            for n in total:
                total[n] += got["launches"][n]
            # the replay holds every choice; the floors catch a rank that
            # takes the wrong rows of a global draw (its own choices would
            # part from the one-process run's, the replayed ones would not)
            same_choices.check(f"rank {r} replaying the one-process run",
                               {"agree": got["agree"]})
            log(f"  rank {r}: ms per step " + ", ".join(f"{t:.1f}" for t in got["ms"])
                + f" replaying, {got['bare_ms']:.1f} a third step without (peak {got['peak_gib']:.2f} GiB, both ranks on one card, {smi})")
        loss_worst = grad_norm_worst = 0.0
        for r, got in enumerate(ranks):
            for s, (m, w) in enumerate(zip(got["metrics"], one_metrics)):
                if set(m) != set(w) or not all(math.isfinite(v) for v in m.values()):
                    raise SystemExit(f"rank {r} step {s + 1}: metrics {m}")
                worst = max(abs(m[k] - w[k]) / max(abs(w[k]), 1e-6) for k in w
                            if k != "grad_norm")
                gn = abs(m["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                loss_worst, grad_norm_worst = max(loss_worst, worst), max(grad_norm_worst, gn)
                if worst > LOSS_RTOL or gn > GROUP_NORM_RTOL:
                    raise SystemExit(f"rank {r} step {s + 1}: loss terms part from one process's "
                                     f"by {worst} (rel), grad_norm by {gn}")
        # the updates per parameter group, the stem's statistics, one model
        update_worst, stats_worst, ranks_apart = {}, 0.0, 0.0
        for r, got in enumerate(ranks):
            for label in set(labels.values()):
                names = [n for n, lab in labels.items() if lab == label]
                a = math.sqrt(sum(float(((got["params"][n] - initial[n]) ** 2).sum())
                                  for n in names))
                b = math.sqrt(sum(float(((one_params[n] - initial[n]) ** 2).sum())
                                  for n in names))
                update_worst[label] = max(update_worst.get(label, 0.0),
                                          abs(a - b) / max(b, 1e-12))
            for n, v in one_stats.items():
                stats_worst = max(stats_worst, float((got["stats"][n] - v).abs().max())
                                  / max(float(v.abs().max()), 1e-12))
        for n, p in ranks[0]["params"].items():
            ranks_apart = max(ranks_apart, float((p - ranks[1]["params"][n]).abs().max()))
        log(f"  {DIST_RANKS} ranks against one process over {DIST_STEPS} steps: loss terms "
            f"{loss_worst:.3e} (rel, LOSS_RTOL {LOSS_RTOL}), grad_norm {grad_norm_worst:.3e}, "
            "the update's norm per parameter group "
            + ", ".join(f"{k} {v:.3e}" for k, v in sorted(update_worst.items()))
            + f" (GROUP_NORM_RTOL {GROUP_NORM_RTOL}), the BatchNorm statistics {stats_worst:.3e}; "
            f"the ranks' parameters apart by {ranks_apart:.3e}; the ranks' call {t_ranks:.1f} s")
        if max(update_worst.values()) > GROUP_NORM_RTOL or stats_worst > GROUP_NORM_RTOL:
            raise SystemExit("the two ranks' update or statistics part from one process's")
        if ranks_apart > 0:
            raise SystemExit(f"the two ranks' parameters differ by {ranks_apart}")
        record.update({"one_ms": one_ms, "rank_ms": [g["ms"] for g in ranks],
                       "one_bare_ms": one_bare_ms[0], "rank_bare_ms": [g["bare_ms"] for g in ranks],
                       "one_peak_gib": one_peak, "rank_peak_gib": [g["peak_gib"] for g in ranks],
                       "loss_rel": loss_worst, "grad_norm_rel": grad_norm_worst,
                       "update_rel": update_worst, "stats_rel": stats_worst,
                       "agree": [g["agree"] for g in ranks], "ranks_call_s": t_ranks})
        del ranks
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # train_net in a torchrun-style group of one: NCCL, DDP, the merge
        backends = []
        real_init = mesh.init_group

        def init_group(backend, *a, **k):
            backends.append(backend)
            return real_init(backend, *a, **k)

        env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(mesh._free_port())}
        saved_env = {k: os.environ.get(k) for k in env}
        out = os.path.join(tmp, "nccl")
        device_args = [] if dev.type == "cuda" else ["--device", "cpu"]
        run_opts = device_args + ["SOLVER.IMS_PER_BATCH", str(DIST_LOCAL_BATCH), "DATASETS.TEST",
                                  f"('{EVAL_NAMES[2]}',)", "OUTPUT_DIR", out] + list(opts)
        os.environ.update(env)
        mesh.init_group = init_group
        try:
            for fn in counters.values():
                fn.launches = 0
            t0 = time.time()
            trained = train_net.main(["--config", DIST_PRESET, "--synthetic", "--max-iter",
                                      str(DIST_STEPS)] + run_opts)
            t_train = time.time() - t0
            wrapped = trained.step_fn.ddp is not None
            del trained
            with open(os.path.join(out, "metrics.jsonl")) as f:
                steps = [json.loads(line) for line in f]
            if [m["step"] for m in steps] != list(range(1, DIST_STEPS + 1)) or not all(
                    np.isfinite(m["total_loss"]) for m in steps):
                raise SystemExit(f"train_net under WORLD_SIZE=1 logged {steps}")
            pairs = eval_dataset(DIST_EVAL_SIZES)
            t0 = time.time()
            with semantic_files(pairs):
                evaluated = train_net.main(["--config", DIST_PRESET, "--eval-only", "--resume"]
                                           + run_opts)
            t_eval = time.time() - t0
            results = evaluated.results[EVAL_NAMES[2]]
            nccl_launches = {n: fn.launches for n, fn in counters.items()}
            del evaluated
        finally:
            mesh.init_group = real_init
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        backend = mesh.default_backend(dev.type)
        if backends != [backend, backend] or not wrapped:
            raise SystemExit(f"train_net under WORLD_SIZE=1 joined {backends}, DDP {wrapped}")
        if not 0 <= results["mIoU"] <= 100 or evaluated_steps(out) != DIST_STEPS:
            raise SystemExit(f"--eval-only gave {results}")
        for n, v in nccl_launches.items():
            total[n] += v
        want_min = {n: v * DIST_STEPS for n, v in DIST_PER_STEP.items() if v and n in counters}
        short = {n: nccl_launches[n] for n in want_min if nccl_launches[n] < want_min[n]}
        if short:
            raise SystemExit(f"the NCCL runs launched {short}, fewer than {want_min}")
        log(f"  train_net under WORLD_SIZE=1 ({backend}, DDP): {DIST_STEPS} steps at batch "
            f"{DIST_LOCAL_BATCH} in {t_train:.1f} s, loss " + ", ".join(
                f"{m['total_loss']:.4f}" for m in steps) + f"; --eval-only --resume on "
            f"{len(pairs)} images in {t_eval:.1f} s: mIoU {results['mIoU']:.3f} ({smi})")
        record.update({"nccl_train_s": t_train, "nccl_eval_s": t_eval,
                       "nccl_miou": results["mIoU"]})
    record["phase_s"] = time.time() - t_phase
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "phase21.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record, total


# phase 22: what the ported models once refused or ignored.  (a) the
# JAX package's flagship (__graft_entry__._flagship_cfg: AFF-Mini, CONVS_DIM
# 128, MASK_FORMER.DROPOUT at its default 0.1) trained as bench.py trains it:
# 512x512, batch 8, SOLVER.AMP.ENABLED; (b) AFF-Mini without the reserved grid
# and with clusters of 64 over neighbourhoods of 48 (K1 and K2 at a 64-token
# span), one block a stage; (c) MaskFiner-Mini, one block a stage, with the
# pre-norm Cat decoder, MASK_DECODER_ALL_LEVELS, a HierUp last stage and the
# stage dropouts at 0.1
DROPOUT_SIZE, DROPOUT_BATCH, DROPOUT_STEPS = 512, 8, 2
DROPOUT_SPAN_OPTS = ["MODEL.AFF.DEPTHS", "[1, 1, 1, 1]", "MODEL.AFF.RESERVE", "False",
                     "MODEL.AFF.CLUSTER_SIZE", "64", "MODEL.AFF.NBHD_SIZE", "[48, 48, 48, 48]"]
DROPOUT_CASCADE_OPTS = [
    "MODEL.MR.DEPTHS", "[1, 1, 1, 1]", "MODEL.MASK_FINER.PRE_NORM", "True",
    "MODEL.MASK_FINER.MASK_DECODER_ALL_LEVELS", "True",
    "MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME", "MultiScaleMaskFinerTransformerDecoderCat",
    "MODEL.MR_SEM_SEG_HEAD.DROPOUT", "0.1", "MODEL.MR.DROP_RATE", "[0.1, 0.1, 0.1, 0.1]",
    # the HierUp stage's decoder reads its three transformer levels: the JAX
    # HierUp decoder hands on its FPN level painted on the whole grid but
    # with its tokens' own positions, which a decoder reading it cannot add
    # (in either package)
    "MODEL.MASK_FINER.DECODER_LEVELS", "[1, 2, 3, 3]"]
# one pixel decoder name a stage (the preset's one name is a string)
DROPOUT_CASCADE_DECODERS = ["MSDeformAttnPixelDecoderMaskFiner"] * 3 + [
    "MSDeformAttnPixelDecoderMaskFinerHierUp"]
# a Dropout's kept share over a step against 1 - rate: within this many
# standard deviations of the binomial share of its elements
DROPOUT_SIGMAS = 5.0
# the kernels each run of (b) and (c) must launch at least once
DROPOUT_PATH_KERNELS = ("local_attn", "local_attn_bwd", "msdetrpc", "msdetrpc_bwd", "knn",
                        "point_sample", "point_sample_bwd", "lapjv")


class dropout_census:
    """Within the block every Dropout of `model` that drops counts the
    elements it keeps and draws (on the card, read once at the end);
    `shares()` -> {module: (kept share, rate, elements, bound)} with bound =
    DROPOUT_SIGMAS binomial standard deviations of the share."""

    def __init__(self, model):
        self.model, self.counts, self.rates = model, {}, {}

    def __enter__(self):
        from autofocusformermod_torch.models.layers import Dropout

        for name, m in self.model.named_modules():
            if isinstance(m, Dropout) and m.rate > 0:
                m.keep_mask = self._wrap(name, m)
        return self

    def _wrap(self, name, module):
        draw = type(module).keep_mask

        def keep_mask(shape, device):
            mask = draw(module, shape, device)
            kept, total = self.counts.get(name, (0, 0))
            self.counts[name] = (kept + mask.sum(), total + mask.numel())
            return mask

        self.rates[name] = module.rate
        return keep_mask

    def __exit__(self, *exc):
        from autofocusformermod_torch.models.layers import Dropout

        for m in self.model.modules():
            if isinstance(m, Dropout) and "keep_mask" in m.__dict__:
                del m.keep_mask

    def shares(self):
        out = {}
        for name, (kept, total) in self.counts.items():
            p = self.rates[name]
            out[name] = (float(kept) / total, p, total,
                         DROPOUT_SIGMAS * math.sqrt(p * (1 - p) / total))
        return out

    def check(self, label):
        """Every Dropout of the model drew, each within its bound; -> the
        worst (|share - (1 - rate)| / bound, module)."""
        shares = self.shares()
        if set(shares) != set(self.rates) or not shares:
            raise SystemExit(f"{label}: Dropouts {sorted(set(self.rates) - set(shares))} drew "
                             f"nothing; {len(shares)} drew")
        worst = max((abs(s - (1 - p)) / b, n) for n, (s, p, t, b) in shares.items())
        for name, (share, p, total, b) in shares.items():
            if abs(share - (1 - p)) > b:
                raise SystemExit(f"{label}: {name} kept {share:.5f} of {total} elements at rate "
                                 f"{p}, outside 1 - rate +- {b:.2e} ({DROPOUT_SIGMAS:g} sigma)")
        log(f"  {label}: {len(shares)} Dropouts drew, each kept share within "
            f"{DROPOUT_SIGMAS:g} sigma of 1 - rate; worst {worst[0]:.2f} of the bound at "
            f"{worst[1]} ({shares[worst[1]][0]:.5f} of {shares[worst[1]][2]} at rate "
            f"{shares[worst[1]][1]})")
        return {"dropouts": len(shares), "worst_of_bound": worst[0], "worst_module": worst[1],
                "shares": {n: s[:3] for n, s in shares.items()}}


@contextlib.contextmanager
def computing_fp32(model):
    """Within the block `model` computes in fp32, as built without
    SOLVER.AMP.ENABLED (every module's compute_dtype; the fp32 masters are
    the weights either way)."""
    import torch

    saved = [(m, m.compute_dtype) for m in model.modules() if hasattr(m, "compute_dtype")]
    for m, _ in saved:
        m.compute_dtype = torch.float32
    try:
        yield
    finally:
        for m, dtype in saved:
            m.compute_dtype = dtype


def profiled_step(fn):
    """(fn(), ms between synchronisations of the card, device busy ms, rows):
    one call under the profiler (raw device events, as device_busy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
    return (out, ms, *device_rows(prof, "profiled_step"))


def dropout_phase(dev, smi, gen, counters, flagship_opts=(), span_opts=(), cascade_opts=(),
                  size=DROPOUT_SIZE, batch=DROPOUT_BATCH, steps=DROPOUT_STEPS,
                  out_dir="chiprun_out"):
    """Phase 22 (a)-(c).  Every model is a Trainer's (seeded random weights,
    synthetic label maps, 100 target slots).  (a) the flagship: `steps`
    steps at `batch`, each replayed through the plain versions first in
    fp32 (replay_step under computing_fp32, LOSS_RTOL: the dropout stream
    restored, so both runs drop alike; under AMP a kernel's last bit moves
    bf16 roundings, and the AFF keep scores' bf16 near ties flip, so the
    tight comparison is the fp32 one, as phase 6's), then the Trainer's AMP
    step under the profiler (ms, device busy, peak GiB; launches per step
    as phase 6's; each Dropout's kept share, dropout_census).  (b) K1, K3 and K9 on a forward's operands and
    K2, K4, K10, the ranking's read and K13 on a real step's, each against
    its plain version; a step replayed through the plain versions, then the
    Trainer's (launches as phase 6's at one block a stage); in train mode
    at ATTN_DROP_RATE 0.1 the kernel path raises.  (c) a step replayed (the
    split order held through each stage's disagreement, as phase 13 holds
    it; matches and ranked points against their scores, as phase 17's
    cascades), then the Trainer's (kept shares held); with
    NUM_REGISTER_TOKENS 2 the cascade raises at stage 0's depthwise conv,
    as JAX's does.  Extra overrides per model for a rehearsal.  Appends the
    records to out_dir/phase22.json.  Returns ({kernel: {path: record}},
    {counter: launches of the phase's runs through the kernels})."""
    import tempfile

    import torch
    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.graft_entry import _flagship_cfg
    from autofocusformermod_torch.losses.criterion import device_draw
    from autofocusformermod_torch.models.maskformer import init_random_weights
    from autofocusformermod_torch.models.registry import build_model
    from autofocusformermod_torch.ops.build import BUILD_DIR

    paths, total, record = {}, dict.fromkeys(counters, 0), {"card": smi, "size": size}

    def reset():
        for c in counters.values():
            c.launches = 0

    def draw(i):
        return device_draw(torch.Generator(device=dev).manual_seed(SEED + i))

    def add(got):
        for name, k in got.items():
            total[name] += k

    def trainer_for(cfg, tmp):
        cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", str(batch), "OUTPUT_DIR", tmp,
                             "INPUT.CROP.SIZE", f"[{size}, {size}]"])
        trainer = Trainer(cfg, dev)
        init_random_weights(trainer.model, torch.Generator().manual_seed(SEED))
        return trainer, synthetic_batches(cfg, dev)

    def steps_of(label, trainer, cfg, batches, n, replay_args, want=None, replay_scope=None):
        """n steps: each replayed (within `replay_scope(model)`), then the
        Trainer's under the profiler."""
        model, recs = trainer.model.train(), []
        for i in range(n):
            b = next(batches)
            with (replay_scope or (lambda m: contextlib.nullcontext()))(model):
                used, r_ms, p_ms, r_peak, p_peak = replay_step(
                    f"{label} step {i + 1}", model, cfg, b, lambda: draw(i + 1), *replay_args)
            reset()
            torch.cuda.reset_peak_memory_stats()
            with dropout_census(model) as census:
                metrics, ms, busy, rows = profiled_step(lambda: trainer.step_fn(b, draw(i + 1)))
            got = {name: c.launches for name, c in counters.items()}
            add(got)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if not all(torch.isfinite(v).all() for v in metrics.values()):
                raise SystemExit(f"{label} step {i + 1}: non-finite metrics")
            log(f"  {label} step {i + 1} at batch {batch} (the Trainer's, profiled): {ms:.1f} ms, "
                f"device busy {busy:.2f} ms in {rows} rows ({busy / ms:.0%}), peak {peak:.2f} "
                f"GiB, total loss {metrics['total_loss'].item():.6f}, grad_norm "
                f"{metrics['grad_norm'].item():.5f}; launches {got}; the replay's plain step "
                f"(batch {used}) {p_ms:.1f} ms, peak {p_peak:.2f} GiB ({smi})")
            if want is not None and any(got[k] != v for k, v in want.items()):
                raise SystemExit(f"{label} step {i + 1}: launched {got}, expected {want}")
            missing = [k for k in DROPOUT_PATH_KERNELS if k in got and not got[k]]
            if missing:
                raise SystemExit(f"{label} step {i + 1}: {missing} never launched")
            kept = census.check(f"{label} step {i + 1}") if census.rates else None
            recs.append({"ms": ms, "busy_ms": busy, "rows": rows, "peak_gib": peak,
                         "plain_ms": p_ms, "plain_peak_gib": p_peak, "replayed_batch": used,
                         "total_loss": metrics["total_loss"].item(), "launches": got,
                         "dropout": kept})
            del b, metrics
        return recs

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="dropout_") as tmp:
        # (a) the flagship as bench.py trains it
        t0 = time.time()
        cfg = _flagship_cfg()
        cfg.merge_from_list(["SOLVER.AMP.ENABLED", "True", *flagship_opts])
        trainer, batches = trainer_for(cfg, os.path.join(tmp, "flagship"))
        rates = sorted({round(m.rate, 6) for m in trainer.model.modules()
                        if type(m).__name__ == "Dropout" and m.rate > 0})
        log(f"  (a) the flagship: CONVS_DIM {cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM}, "
            f"{cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS} encoder layers, "
            f"{cfg.MODEL.MASK_FORMER.DEC_LAYERS} decoder layers, MASK_FORMER.DROPOUT "
            f"{cfg.MODEL.MASK_FORMER.DROPOUT} (Dropout rates {rates}), AMP "
            f"{cfg.SOLVER.AMP.ENABLED}, {sum(p.numel() for p in trainer.model.parameters()) / 1e6:.2f}M "
            "parameters")
        if cfg.MODEL.MASK_FORMER.DROPOUT != 0.1 or rates != [0.1]:
            raise SystemExit(f"the flagship trains at MASK_FORMER.DROPOUT "
                             f"{cfg.MODEL.MASK_FORMER.DROPOUT}, Dropout rates {rates}")
        per_step = {"local_attn": sum(cfg.MODEL.AFF.DEPTHS), "msdetrpc": 18, "knn": 10,
                    "local_attn_bwd": sum(cfg.MODEL.AFF.DEPTHS), "msdetrpc_bwd": 18,
                    "point_sample": 2, "point_sample_bwd": 1, "lapjv": 1,
                    "point_sample_nearest": 0, "point_sample_nearest_rows": 1}
        record["flagship"] = {"steps": steps_of(
            "(a) flagship", trainer, cfg, batches, steps, (),
            {k: v for k, v in per_step.items() if k in counters}, computing_fp32)}
        record["flagship"]["seconds"] = time.time() - t0
        del trainer, batches
        torch.cuda.empty_cache()

        # (b) no reserved grid, clusters of 64 over neighbourhoods of 48
        t0 = time.time()
        cfg = PRESETS["aff_mini"]()
        cfg.merge_from_list([*DROPOUT_SPAN_OPTS, *span_opts])
        trainer, batches = trainer_for(cfg, os.path.join(tmp, "span"))
        model = trainer.model
        key = "aff_mini_unreserved_span64"
        label = f"(b) {key}"
        image = torch.randint(0, 256, (1, size, size, 3), dtype=torch.uint8,
                              generator=torch.Generator().manual_seed(SEED + 5)).to(dev)
        ops = path_forward_operands(model.eval(), image)
        spans = sorted({int(args[8]) for args in ops["local_attn"]})
        nnc = sorted({int(args[4].shape[-1]) for args in ops["local_attn"]})
        log(f"  {label}: K1's spans {spans}, neighbour clusters {nnc}")
        if spans != [cfg.MODEL.AFF.CLUSTER_SIZE] or nnc != [1]:
            raise SystemExit(f"{label}: K1 took spans {spans} over {nnc} clusters")
        del ops
        hold_forward_operands(key, model, image, paths)
        hold_grid_step_operands(f"{key}_step", model.train(), cfg, next(batches), gen, paths,
                                local_attn=True)
        per_step.update(local_attn=sum(cfg.MODEL.AFF.DEPTHS),
                        local_attn_bwd=sum(cfg.MODEL.AFF.DEPTHS))
        record["span"] = {"spans": spans, "steps": steps_of(
            label, trainer, cfg, batches, 1, (),
            {k: v for k, v in per_step.items() if k in counters})}
        cfg.defrost()
        cfg.MODEL.AFF.ATTN_DROP_RATE = 0.1
        refusing = build_model(cfg).to(dev).train()
        try:
            with torch.no_grad():
                refusing(image)
        except NotImplementedError as e:
            log(f"  {label}: train mode at ATTN_DROP_RATE 0.1 on the kernel path raises: {e}")
        else:
            # the CPU's plain path drops the probabilities, as JAX's gather path
            if dev.type == "cuda":
                raise SystemExit(f"{label}: attention dropout ran on the local_attn kernel")
        record["span"]["seconds"] = time.time() - t0
        del trainer, batches, model, refusing, image
        torch.cuda.empty_cache()

        # (c) the MaskFiner options with the stage dropouts
        t0 = time.time()
        cfg = PRESETS["maskfiner_mini"]()
        cfg.merge_from_list([*DROPOUT_CASCADE_OPTS, *cascade_opts])
        cfg.MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME = list(DROPOUT_CASCADE_DECODERS)
        trainer, batches = trainer_for(cfg, os.path.join(tmp, "cascade"))
        stages = trainer.model.mask_predictors
        label = "(c) maskfiner_mini_options"
        log(f"  {label}: pixel decoders {[type(p.pixel_decoder).__name__ + ('/hierup' if getattr(p.pixel_decoder, 'hierup', False) else '') for p in stages]}, "
            f"decoders pre-norm "
            f"{all(l.pre_norm for p in stages for l in p.mask_decoder.transformer_ffn_layers)}, "
            f"concatenated levels {[p.mask_decoder.cat_features for p in stages]}, mask features "
            f"on every stage {all(p.pixel_decoder.mask_features is not None for p in stages)}")
        record["cascade"] = {"steps": steps_of(
            label, trainer, cfg, batches, 1,
            (True, LOSS_RTOL, GROUP_NORM_RTOL, None, None, True))}
        cfg.defrost()
        cfg.MODEL.MR.NUM_REGISTER_TOKENS = 2
        with_registers = build_model(cfg).to(dev).eval()
        try:
            with torch.no_grad():
                with_registers(next(batches)["image"][:1])
        except ValueError as e:
            log(f"  {label}: NUM_REGISTER_TOKENS 2 builds "
                f"({tuple(with_registers.mask_predictors[0].backbone.register_tokens.shape)} "
                f"zeros) and raises as JAX's reshape does: {e}")
        else:
            raise SystemExit(f"{label}: register tokens ran through stage 0's depthwise conv")
        record["cascade"]["seconds"] = time.time() - t0
        del trainer, batches, with_registers
        torch.cuda.empty_cache()
    record["kernels"] = paths
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "phase22.json"), "a") as f:
        f.write(json.dumps(record, default=str) + "\n")
    return paths, total


# Phase 23: the stages and backends the port once refused: (a) MaskFiner-Mini
# at its published widths with a ConvNeXtV2 first stage and XAttn stages
# after it; (b) a MixResNeighbour first stage, one block a stage; (c) the
# eval-time dynamic split ratios; (d) the auction and the downsampled
# criterion beside the default solver, and the demo's AsyncPredictor
XATTN_NAMES = ["ConvNeXtV2", "MixResNeighbourXAttn", "MixResNeighbourXAttn",
               "MixResNeighbourXAttn"]
XATTN_BATCH = 4
XATTN_FIRST_OPTS = ["MODEL.MR.DEPTHS", "[1, 1, 1, 1]"]
XATTN_THRESHOLD = 0.5
XATTN_BUCKETS = (0.1, 0.25, 0.5, 0.75, 1.0)
ASYNC_IMAGES = 4
# the share of an AsyncPredictor result's pixels that must equal the
# synchronous call's (a pixel whose class scores tie within the last bits of
# two runs may part)
ASYNC_AGREE_MIN = 0.999
# the auction's costs against K13's: within Q * eps_final, plus the fp32
# rounding of the sums (this share of the summed |cost| of the valid slots)
AUCTION_ROUNDING = 1e-6


def host_k_split(scores, n_curr, threshold, buckets, cap=1.0):
    """The dynamic split rule written out on the host, apart from
    models/mixres.py: the batch's largest share of scores above the
    threshold, clamped to [0.1, cap], the first bucket not below it (the
    largest bucket where none is), capped; that share of n_curr, at least
    1."""
    share = max(float((row > threshold).sum()) / row.size for row in scores)
    share = min(max(share, 0.1), cap)
    fits = [r for r in sorted(buckets) if r >= share]
    ratio = min(fits[0] if fits else max(buckets), cap)
    return max(1, int(n_curr * ratio))


def auction_bound(cost, phases=6):
    """(b,) Q * eps_final of each problem of cost (b, Q, T): the last
    phase's eps of the auction, half the range of the benefits (the negated
    costs shifted per target, Q - T rows of zeros beside them) over 8 ** (phases - 1)."""
    import torch

    b, q, t = cost.shape
    benefit = -cost.double().transpose(1, 2)
    benefit = benefit - benefit.amax(dim=2, keepdim=True)
    lo, hi = benefit.amin(dim=(1, 2)), benefit.amax(dim=(1, 2))
    if t < q:
        lo, hi = torch.clamp(lo, max=0.0), torch.clamp(hi, min=0.0)
    return q * torch.clamp(hi - lo, min=1e-3) / 2.0 / 8.0 ** (phases - 1)


def check_cascade_forward(label, model, cfg, images, counters, expected):
    """A batch forward of a cascade through the kernels (launches against
    `expected`) against the plain run that replays its choices
    (check_cascade); -> (ms of the kernel run, launches, its outputs)."""
    import torch
    from autofocusformermod_torch.ops.dispatch import plain_versions

    book, gini = {}, ([], [])
    with torch.no_grad():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        with same_choices(book, record=True), gini_inputs(gini[0]):
            out = model(images)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        launches = {name: c.launches for name, c in counters.items()}
        with same_choices(book, record=False), plain_versions(), gini_inputs(gini[1]):
            ref = model(images)
    log(f"  {label}: batch-{images.shape[0]} forward {ms:.1f} ms (first call); launches "
        f"{launches} (expected {expected}); tokens per stage "
        f"{[tuple(d.shape) for d in out['disagreement_masks']]}")
    if launches != expected:
        raise SystemExit(f"{label}: the forward launched {launches}, expected {expected}")
    check_cascade(label, out, ref, book, gini)
    del ref, book, gini
    return ms, launches, out


def xattn_phase(dev, smi, gen, counters, opts=(), first_opts=(), size=SIZE, batch=XATTN_BATCH,
                out_dir="chiprun_out"):
    """Phase 23 (a)-(d).  (a) MaskFiner-Mini at its published widths with
    MR.NAME XATTN_NAMES, a Trainer's (seeded random weights, synthetic label
    maps): K1, K3 and K9 on the operands of a batch-`batch` forward, each
    against its plain version; that forward against the plain run replaying
    its choices (check_cascade); one step replayed through the plain versions
    (replay_step: loss terms, group norms, the split order through each
    stage's disagreement), then the Trainer's under the profiler (ms, device
    busy, peak GiB, launches against maskfiner_step_launches).  (b) a
    MixResNeighbour first stage, one block a stage: a forward against the
    plain run.  (c) maskfiner_dynamic_eval on (a)'s model: with the one
    bucket UPSCALE_RATIO it replays the static forward's choices and equals
    it within FORWARD_RTOL; with XATTN_BUCKETS at XATTN_THRESHOLD each
    stage's split count equals host_k_split of its predecessor's
    disagreement.  (d) on the stacked matcher costs of (a)'s outputs, the
    auction against K13 (total cost within auction_bound); the downsampled
    criterion on the card against its CPU run with the card's matches
    replayed (LOSS_RTOL); the demo's AsyncPredictor over ASYNC_IMAGES images
    against the synchronous calls.  Extra overrides for a rehearsal.
    Appends its records to out_dir/phase23.json.  Returns ({kernel: {path:
    record}}, {counter: launches of (a)-(c)'s runs and the demo's calls})."""
    import tempfile

    import numpy as np
    import torch
    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from autofocusformermod_torch.demo import AsyncPredictor, VisualizationDemo
    from autofocusformermod_torch.engine.train import Trainer
    from autofocusformermod_torch.engine.train_step import TrainStep, device_masks
    from autofocusformermod_torch.losses import criterion
    from autofocusformermod_torch.losses.auction import auction_lsap
    from autofocusformermod_torch.losses.criterion import device_draw, set_criterion_downsample
    from autofocusformermod_torch.losses.lapjv import lapjv
    from autofocusformermod_torch.models.maskfiner import maskfiner_dynamic_eval
    from autofocusformermod_torch.models.maskformer import init_random_weights
    from autofocusformermod_torch.models.registry import build_model
    from autofocusformermod_torch.ops.build import BUILD_DIR
    from autofocusformermod_torch.tools.l2_rate import l2_read_rate

    paths, total, record = {}, dict.fromkeys(counters, 0), {"card": smi, "size": size}

    def reset():
        for c in counters.values():
            c.launches = 0

    def add(got):
        for name, k in got.items():
            total[name] += k

    def draw(i):
        return device_draw(torch.Generator(device=dev).manual_seed(SEED + i))

    def launches():
        return {name: c.launches for name, c in counters.items()}

    images = torch.randint(0, 256, (batch, size, size, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(SEED + 23)).to(dev)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR.parent, prefix="xattn_") as tmp:
        # (a) ConvNeXtV2 first, XAttn after
        t0 = time.time()
        cfg = PRESETS[MASKFINER]()
        cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", str(batch), "OUTPUT_DIR", tmp,
                             "INPUT.CROP.SIZE", f"[{size}, {size}]", *opts])
        cfg.MODEL.MR.NAME = list(XATTN_NAMES)
        trainer = Trainer(cfg, dev)
        init_random_weights(trainer.model, torch.Generator().manual_seed(SEED))
        model, batches = trainer.model.eval(), synthetic_batches(cfg, dev)
        label = "(a) maskfiner_mini_xattn"
        stages = [type(p.backbone).__name__ + ("/xattn" if getattr(p.backbone, "x_attn_patcher",
                                                                     None) is not None else "")
                  for p in model.mask_predictors]
        log(f"  {label}: stages {stages}, EMBED_DIM {cfg.MODEL.MR.EMBED_DIM}, DEPTHS "
            f"{cfg.MODEL.MR.DEPTHS}, {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
            f"parameters")
        ops = path_forward_operands(model, images)
        paths["local_attn"] = {"maskfiner_mini_xattn": check_local_attn_calls(label,
                                                                              ops["local_attn"])}
        paths["msdetrpc"] = {"maskfiner_mini_xattn": check_msdetrpc(label, ops["msdetrpc"],
                                                                    l2_read_rate())}
        paths["knn"] = {"maskfiner_mini_xattn": check_knn(label, ops["knn"])}
        del ops
        torch.cuda.empty_cache()
        expected = {n: maskfiner_launches(cfg).get(n, 0) for n in counters}
        fwd_ms, got, static = check_cascade_forward(label, model, cfg, images, counters, expected)
        add(got)
        record["xattn"] = {"forward_ms": fwd_ms, "launches": got}
        model.train()
        step_b = next(batches)
        used, r_ms, p_ms, r_peak, p_peak = replay_step(
            f"{label} step 1", model, cfg, step_b, lambda: draw(1), True, LOSS_RTOL,
            GROUP_NORM_RTOL, None, None, True)
        reset()
        torch.cuda.reset_peak_memory_stats()
        metrics, ms, busy, rows = profiled_step(lambda: trainer.step_fn(step_b, draw(1)))
        got = launches()
        add(got)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {n: maskfiner_step_launches(cfg, size).get(n, 0) for n in counters}
        log(f"  {label} step at batch {batch} (the Trainer's, profiled): {ms:.1f} ms, device busy "
            f"{busy:.2f} ms in {rows} rows ({busy / ms:.0%}), peak {peak:.2f} GiB, total loss "
            f"{metrics['total_loss'].item():.6f}; launches {got} (expected {want}); the replay's "
            f"plain step (batch {used}) {p_ms:.1f} ms, peak {p_peak:.2f} GiB ({smi})")
        if not all(torch.isfinite(v).all() for v in metrics.values()):
            raise SystemExit(f"{label}: non-finite metrics")
        if got != want:
            raise SystemExit(f"{label} step: launched {got}, expected {want}")
        record["xattn"].update(step_ms=ms, busy_ms=busy, rows=rows, peak_gib=peak,
                               plain_step_ms=p_ms, plain_peak_gib=p_peak, replayed_batch=used,
                               step_launches=got, total_loss=metrics["total_loss"].item())
        record["xattn"]["seconds"] = time.time() - t0
        model.eval()
        torch.cuda.empty_cache()

        # (c) the dynamic split ratios on (a)'s model
        t0 = time.time()
        label = "(c) maskfiner_dynamic_eval"
        ratio = float(cfg.MODEL.MR.UPSCALE_RATIO[1])
        book = {}
        with torch.no_grad():
            reset()
            with same_choices(book, record=True):
                static = model(images)
            with same_choices(book, record=False):
                fixed = maskfiner_dynamic_eval(model, images, buckets=(ratio,))
            got = launches()
            add(got)
            if got != {n: 2 * v for n, v in expected.items()}:
                raise SystemExit(f"{label}: the static forward and the dynamic eval launched "
                                 f"{got}, expected twice {expected}")
            counts = {}
            for i, d in enumerate(static["disagreement_masks"][:-1]):
                counts[i + 1] = int(d.shape[1] - (0 if i == 0 else static["disagreement_masks"][
                    i - 1].shape[1]))
            if list(fixed["k_splits"][1:]) != [max(1, int(n * ratio)) for n in counts.values()]:
                raise SystemExit(f"{label}: at the one bucket {ratio} the split counts are "
                                 f"{fixed['k_splits']}, not the static ones of {counts}")
            worst = 0.0
            for key in ("pred_logits", "pred_masks"):
                e = (fixed[key] - static[key]).abs().max().item()
                worst = max(worst, e / max(static[key].abs().max().item(), 1.0))
            if worst > FORWARD_RTOL or not torch.equal(fixed["features_pos"],
                                                       static["features_pos"]):
                raise SystemExit(f"{label}: at the one bucket {ratio} it parts from the static "
                                 f"forward by {worst:.3e} (limit {FORWARD_RTOL}) or in positions")
            same_choices.check(f"{label} at the one bucket {ratio}", book)
            reset()
            dyn = maskfiner_dynamic_eval(model, images, threshold=XATTN_THRESHOLD,
                                         buckets=XATTN_BUCKETS)
            got = launches()
            add(got)
            if got != expected:
                raise SystemExit(f"{label}: the dynamic eval launched {got}, expected {expected}")
        # each stage's count from its predecessor's disagreement over the
        # newest scale's tokens: the grid of the first stage, then the four
        # children of each token the stage split
        n_curr = (size // cfg.MODEL.MR.PATCH_SIZES[0]) ** 2
        host = []
        for li in range(1, len(XATTN_NAMES)):
            scores = dyn["disagreement_masks"][li - 1][:, -n_curr:].float().cpu().numpy()
            host.append(host_k_split(scores, n_curr, XATTN_THRESHOLD, XATTN_BUCKETS))
            n_curr = 4 * dyn["k_splits"][li]
        log(f"  {label}: at the one bucket {ratio}: split counts {list(fixed['k_splits'][1:])}, "
            f"worst rel diff to the static forward {worst:.3e}; at threshold {XATTN_THRESHOLD} "
            f"over {XATTN_BUCKETS}: split counts {list(dyn['k_splits'][1:])}, host {host}, final "
            f"tokens {dyn['features_pos'].shape[1]} (static {static['features_pos'].shape[1]}); "
            f"launches {got}")
        if list(dyn["k_splits"][1:]) != host:
            raise SystemExit(f"{label}: split counts {dyn['k_splits']} against the host's {host}")
        if not all(torch.isfinite(dyn[k]).all() for k in ("pred_logits", "pred_masks")):
            raise SystemExit(f"{label}: non-finite outputs")
        record["dynamic"] = {"k_splits": list(dyn["k_splits"][1:]), "host": host,
                             "final_tokens": int(dyn["features_pos"].shape[1]),
                             "static_tokens": int(static["features_pos"].shape[1]),
                             "one_bucket_rel_diff": worst, "seconds": time.time() - t0}
        del fixed, dyn, static, book
        torch.cuda.empty_cache()

        # (d) the backends on (a)'s outputs
        t0 = time.time()
        label = "(d) backends"
        step = TrainStep(model, cfg)
        batch_d = next(batches)
        targets = {"labels": batch_d["labels"], "masks": device_masks(batch_d),
                   "valid": batch_d["valid"]}
        costs, real = [], criterion.solve_lsap
        with torch.no_grad():
            outputs = model(batch_d["image"])
            criterion.solve_lsap = lambda c: (costs.append(c.detach().clone()), real(c))[1]
            try:
                criterion.set_criterion(outputs, targets, step.num_classes, draw(4),
                                        **step.criterion)
            finally:
                criterion.solve_lsap = real
            auction = []
            for cost in costs:
                torch.cuda.synchronize()
                t1 = time.time()
                a = auction_lsap(cost)
                torch.cuda.synchronize()
                a_ms = (time.time() - t1) * 1e3
                k = lapjv(cost)
                q, t = cost.shape[1:]
                valid = cost[:, 0, :] < 1e8
                picked = [torch.gather(cost.double(), 1, m[:, None, :])[:, 0] for m in (a, k)]
                sums = [(p * valid).sum(1) for p in picked]
                bound = auction_bound(cost) + AUCTION_ROUNDING * (picked[1].abs() * valid).sum(1)
                excess = sums[0] - sums[1]
                perm = all(int(torch.unique(r).numel()) == t for r in a)
                auction.append({"shape": list(cost.shape), "ms": a_ms,
                                "worst_excess": float(excess.max()),
                                "worst_share_of_bound": float((excess / bound).max()),
                                "same_matches": float((a == k).double().mean())})
                log(f"  {label}: auction_lsap on the stacked costs {tuple(cost.shape)}: {a_ms:.1f} "
                    f"ms, a permutation of the queries {perm}; its total cost over K13's at worst "
                    f"{float(excess.max()):.3e} ({float((excess / bound).max()):.3f} of Q * "
                    f"eps_final + rounding), matches equal {auction[-1]['same_matches']:.4f}")
                if not perm or bool((excess > bound).any()) or bool((excess < -bound).any()):
                    raise SystemExit(f"{label}: the auction's assignment is no permutation or "
                                     f"costs {excess.tolist()} against the bound {bound.tolist()}")
            book = {}
            with same_choices(book, record=True):
                k_total, k_terms, _ = set_criterion_downsample(outputs, targets, step.num_classes,
                                                               **step.criterion)
            for key, rec in list(book.items()):
                if isinstance(rec, list):
                    book[key] = [r.cpu() if torch.is_tensor(r) else r for r in rec]
            cpu_out = {"pred_logits": outputs["pred_logits"].cpu(),
                       "pred_masks": outputs["pred_masks"].cpu(),
                       "aux_outputs": [{k: v.cpu() for k, v in a.items()}
                                       for a in outputs["aux_outputs"]]}
            with same_choices(book, record=False):
                p_total, p_terms, _ = set_criterion_downsample(
                    cpu_out, {k: v.cpu() for k, v in targets.items()}, step.num_classes,
                    **step.criterion)
        rel = max(abs(k_terms[n].item() - p_terms[n].item()) / max(abs(p_terms[n].item()), 1e-6)
                  for n in p_terms)
        log(f"  {label}: set_criterion_downsample on the card {k_total.item():.6f}, on the CPU "
            f"{p_total.item():.6f}; {len(p_terms)} loss terms, worst rel diff {rel:.3e} (limit "
            f"{LOSS_RTOL})")
        same_choices.check(f"{label} downsampled criterion", book)
        if rel > LOSS_RTOL or not math.isfinite(k_total.item()):
            raise SystemExit(f"{label}: the downsampled criterion on the card parts from the CPU's "
                             f"by {rel}")
        del outputs, cpu_out, costs
        torch.cuda.empty_cache()
        demo = VisualizationDemo(cfg, model=model)
        rng = np.random.default_rng(SEED + 23)
        imgs = [rng.integers(0, 256, (size, size + 64 * i, 3), dtype=np.uint8)
                for i in range(ASYNC_IMAGES)]
        reset()
        sync = [demo.run_on_image(im) for im in imgs]
        pred_async = AsyncPredictor(demo.run_on_image)
        try:
            for im in imgs:
                pred_async.put(im)
            got_async = [pred_async.get() for _ in imgs]
        finally:
            pred_async.shutdown()
        got = launches()
        add(got)
        want = {n: 2 * len(imgs) * maskfiner_launches(cfg).get(n, 0) for n in counters}
        if got != want:
            raise SystemExit(f"{label}: the demo's {2 * len(imgs)} calls launched {got}, expected "
                             f"{want}")
        agree = [float((a == b).mean()) if a.shape == b.shape else 0.0
                 for a, b in zip(got_async, sync)]
        log(f"  {label}: AsyncPredictor over {len(imgs)} images {[im.shape[:2] for im in imgs]}: "
            f"results in order of shapes {[a.shape for a in got_async]}, pixels equal to the "
            f"synchronous calls' {agree} (floor {ASYNC_AGREE_MIN}); worker stopped "
            f"{not pred_async._thread.is_alive()}")
        if min(agree) < ASYNC_AGREE_MIN or pred_async._thread.is_alive():
            raise SystemExit(f"{label}: AsyncPredictor's results part from the synchronous ones: "
                             f"{agree}")
        record["backends"] = {"auction": auction, "downsample_rel_diff": rel,
                              "async_agree": agree, "seconds": time.time() - t0}
        del trainer, batches, model, demo, step
        torch.cuda.empty_cache()

        # (b) a MixResNeighbour first stage
        t0 = time.time()
        label = "(b) maskfiner_mini_neighbour_first"
        cfg = PRESETS[MASKFINER]()
        cfg.merge_from_list([*XATTN_FIRST_OPTS, *first_opts])
        cfg.MODEL.MR.NAME = ["MixResNeighbour"] + list(cfg.MODEL.MR.NAME[1:])
        model = build_model(cfg)
        init_random_weights(model, torch.Generator().manual_seed(SEED))
        model = model.to(dev).eval()
        expected = {n: maskfiner_launches(cfg).get(n, 0) for n in counters}
        fwd_ms, got, _ = check_cascade_forward(label, model, cfg, images, counters, expected)
        add(got)
        record["neighbour_first"] = {"forward_ms": fwd_ms, "launches": got,
                                     "seconds": time.time() - t0}
        del model
        torch.cuda.empty_cache()
    record["kernels"] = paths
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "phase23.json"), "a") as f:
        f.write(json.dumps(record, default=str) + "\n")
    return paths, total


def evaluated_steps(out):
    """The step of the latest checkpoint under a run's OUTPUT_DIR."""
    from autofocusformermod_torch.engine.checkpoint import Checkpointer

    return Checkpointer(os.path.join(out, "checkpoints")).latest_step()


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
    from autofocusformermod_torch.tools.l2_rate import l2_read_rate

    dev = torch.device("cuda", 0)
    log("phase 1: build")
    t0 = time.time()
    lib_path = build_library()
    load_kernels()
    log(f"  built {lib_path.name} in {time.time() - t0:.1f} s")

    log("phase 2: kernels against their plain versions, 512x512 batch-4 shapes")
    gen = torch.Generator().manual_seed(SEED)
    local_attn_paths = {"aff_mini_b4_forward": check_local_attn(dev, gen, "aff_mini", BATCH)}
    msdetrpc_paths = {"b4_forward": check_msdetrpc("b4_forward",
                                                   msdetrpc_uniform_calls(dev, gen, BATCH)),
                      "generic": {"max_abs_err": check_msdetrpc_generic(dev, gen)}}
    from autofocusformermod_torch.geometry.knn import knn_route

    knn_path = path_knn_operands(dev)
    knn_paths = {"b4_forward": check_knn("b4 grid", knn_grid_cases(dev, gen, BATCH)),
                 "b4_path": check_knn("b4 path", knn_path)}
    # the routes the forward's knn calls take, from their shapes
    knn_routes = {r: 0 for r in knn.launches_by_route}
    for _, query, db, k in knn_path:
        knn_routes[knn_route(db.shape[1])] += 1
    del knn_path

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
    book = {}
    with torch.no_grad():
        for fn in counters.values():
            fn.launches = 0
        knn_before = dict(knn.launches_by_route)
        torch.cuda.synchronize()
        t0 = time.time()
        with same_choices(book, record=True):
            out = model(images)
        torch.cuda.synchronize()
        t_fwd = time.time() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        knn_by_route = {r: n - knn_before[r] for r, n in knn.launches_by_route.items()}
        with same_choices(book, record=False), plain_versions():
            ref = model(images)
    log(f"  first forward {t_fwd:.3f} s; launches {launches} (expected {expected}); knn by "
        f"route {knn_by_route} (expected from the shapes {knn_routes})")
    if knn_by_route != knn_routes:
        raise SystemExit(f"knn took the routes {knn_by_route} in the forward; its shapes give "
                         f"{knn_routes}")
    for name, n in launches.items():
        if n != expected[name]:
            raise SystemExit(f"{name}: launched {n} times in the forward, expected {expected[name]}")
    inference_launches = launches
    check_forward("AFF-Mini forward", out, ref, book)
    del book

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
    del model, predictor, out, ref
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
    l2_rate = l2_read_rate()
    log(f"  the card's L2 read rate (tools/l2_rate.py: 24 MiB resident in L2, 16-byte loads "
        f"past L1): {l2_rate / 1e12:.3f} TB/s")
    for b in sorted({TRAIN_BATCH, SMALL_BATCH}):
        msdetrpc_paths[f"b{b}_step"] = check_msdetrpc(
            f"b{b}_step", msdetrpc_uniform_calls(dev, gen, b), l2_rate)
        knn_paths[f"b{b}_step"] = check_knn(f"b{b} grid", knn_grid_cases(dev, gen, b))
    # the operands the main path gives K3, K4 and K10 at a batch-8 step
    md_path = [(*call, 1) for call in path_msdetrpc_operands(dev)]
    msdetrpc_paths[f"b{TRAIN_BATCH}_path"] = check_msdetrpc(f"b{TRAIN_BATCH}_path", md_path,
                                                            l2_rate)
    ps_path = path_point_sample_operands(dev)
    lapjv_path = path_lapjv_operands(dev)
    kernels = [local_attn_record(local_attn_paths), msdetrpc_record(msdetrpc_paths),
               knn_record(knn_paths), local_attn_bwd_record(local_attn_bwd_paths),
               check_msdetrpc_bwd(dev, gen, md_path), check_point_sample(dev, gen, ps_path),
               check_lapjv(dev, gen, lapjv_path)]
    del md_path, ps_path, lapjv_path
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
    by_route = {fn: dict(fn.launches_by_route)
                for fn in (point_sample_bilinear, point_sample_backward, lapjv)}
    mini_launches = train_phase(dev, smi, train_counters)
    for name, n in per_step.items():
        if mini_launches[name] != n * TRAIN_STEPS:
            raise SystemExit(f"{name}: launched {mini_launches[name]} times in {TRAIN_STEPS} "
                             f"training steps, expected {n} per step")
    # per step: the targets' 512x512 masks on the direct route, the logits'
    # 128x128 masks (forward and backward) on the shared one
    by_route = {fn.__name__: {r: fn.launches_by_route[r] - k for r, k in routes.items()}
                for fn, routes in by_route.items()}
    log(f"  point_sample and lapjv launches by route, all of phase 6: {by_route}")
    if by_route["lapjv"]["warp"] < TRAIN_STEPS or by_route["lapjv"]["block"]:
        raise SystemExit(f"lapjv took the routes {by_route['lapjv']}; the matcher's 100 x 100 "
                         "problems belong to the warp route")
    if (by_route["point_sample_bilinear"]["direct"] < TRAIN_STEPS
            or by_route["point_sample_bilinear"]["shared"] < TRAIN_STEPS
            or by_route["point_sample_backward"]["shared"] < TRAIN_STEPS
            or by_route["point_sample_backward"]["direct"]):
        raise SystemExit(f"point_sample took the routes {by_route}; the targets belong to the "
                         "direct route, the logits and their backward to the shared one")
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

    for name in SAMPLING:
        kernels.append(sampling_record(name, gen, dev, l2_rate))
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
    layout_launches, layout_paths = layouts_phase(dev, smi, images, default_out, {
        **layout_counters, "point_sample_nearest": point_sample_nearest,
        "point_sample_nearest_rows": point_sample_nearest_rows})
    for kr in kernels:
        for path, rec in layout_paths.get(kr["name"], {}).items():
            kr["by_path"][path] = rec
    by_route = {r: windowed_row_gather.launches_by_route[r] - n for r, n in by_route.items()}
    log(f"  window_gather launches by route on the layouts' forwards and steps: {by_route}")
    if by_route["direct"] or by_route["shared"] < 18:
        raise SystemExit(f"the channel-major prep's lookups took the routes {by_route}; the "
                         "path's shape belongs to the shared route")
    del images, default_out
    torch.cuda.empty_cache()

    log(f"phase 10: the published 1/5 preset ({MINI15}) at {SIZE}x{SIZE}: a batch-{BATCH} "
        f"forward and a batch-{TRAIN_BATCH} step in the default layout and with "
        "USE_STACKED_GLUE off, against the plain versions")
    mini15_launches = mini15_phase(dev, smi, {**train_counters, **layout_counters})
    torch.cuda.empty_cache()

    log(f"phase 11: the published MaskFiner-Mini cascade ({MASKFINER}) at {SIZE}x{SIZE}: K1, K3 "
        f"and K9 on the operands of a batch-{BATCH} forward, the forward against the plain "
        "versions, the predictor")
    maskfiner_paths, maskfiner_fwd_launches = maskfiner_phase(dev, smi, gen)
    for kr in kernels:
        if kr["name"] in maskfiner_paths:
            kr["by_path"][MASKFINER] = maskfiner_paths[kr["name"]]
            kr["max_abs_err"] = max(kr["max_abs_err"], maskfiner_paths[kr["name"]]["max_abs_err"])

    log(f"phase 12: evaluation and the dataset path: {EVAL_PRESET} (one block a stage) trained "
        f"{EVAL_STEPS} steps "
        f"from TrainLoader with test() every {EVAL_PERIOD}, --eval-only, the test() images "
        f"against the plain versions, {MASKFINER} --eval-only; {len(EVAL_SIZES)} ADE20K-shaped "
        "pairs")
    eval_launches, eval_paths = eval_phase(dev, smi, {**train_counters, **layout_counters},
                                           ONE_BLOCK_AFF, ONE_BLOCK_MR)
    torch.cuda.empty_cache()
    for kr in kernels:
        for path, rec in eval_paths.get(kr["name"], {}).items():
            kr["by_path"][path] = rec
            kr["max_abs_err"] = max(kr["max_abs_err"], rec["max_abs_err"])

    log(f"phase 13: the published MaskFiner-Mini cascade's training step ({MASKFINER}) at "
        f"{SIZE}x{SIZE}, batch {MASKFINER_TRAIN_BATCH}: K2, K4, K10, K11, K12 and K13 on the "
        f"operands of a real step, {MASKFINER_TRAIN_STEPS} steps against the plain versions, "
        "train_net with checkpoints and resume")
    mft_paths, mft_launches = maskfiner_train_phase(dev, smi, gen, train_counters)
    for kr in kernels:
        if kr["name"] in mft_paths:
            kr.setdefault("by_path", {"b8_uniform": {k: kr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
            kr["by_path"][MASKFINER_TRAIN] = mft_paths[kr["name"]]
            kr["max_abs_err"] = max(kr["max_abs_err"], mft_paths[kr["name"]]["max_abs_err"])
    torch.cuda.empty_cache()

    log(f"phase 14: panoptic and instance segmentation: {PAN_PRESET} (one block a stage) trained "
        f"{PAN_STEPS} steps "
        f"at batch {PAN_BATCH} from the panoptic mapper with test() (PQ) at 1024x2048, "
        f"{INST_PRESET} {INST_STEPS} LSJ steps at 1024x1024, batch {INST_BATCH}, with test() "
        "(COCO mask AP) at 800x1333; a test image of each against the plain versions; K1, K3 "
        "and K9 at 131,072 tokens, K2, K4, K10, K12 and K13 on a real step of each")
    pi_launches, pi_paths = panoptic_instance_phase(dev, smi, gen,
                                                    {**train_counters, **layout_counters},
                                                    pan_opts=ONE_BLOCK_AFF)
    for kr in kernels:
        for path, rec in pi_paths.get(kr["name"], {}).items():
            kr.setdefault("by_path", {"b8_uniform": {k: kr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
            kr["by_path"][path] = rec
            kr["max_abs_err"] = max(kr["max_abs_err"], rec["max_abs_err"])
    torch.cuda.empty_cache()

    log(f"phase 15: the grid baselines: {GRID_SWIN} at 640x640 (a batch-{GRID_SWIN_BATCH} "
        f"forward, {GRID_SWIN_STEPS} steps at batch {GRID_SWIN_BATCH}) and {GRID_R50} at "
        f"{SIZE}x{SIZE} (a batch-{BATCH} forward against the plain versions, {GRID_R50_STEPS} "
        f"steps at batch {TRAIN_BATCH}), each step replayed through the plain versions, the "
        f"kernels on their own operands, test() on {len(GRID_EVAL_SIZES)} ADE20K-shaped images")
    grid_paths, grid_launches_ = grid_baselines_phase(dev, smi, gen,
                                                      {**train_counters, **layout_counters})
    for kr in kernels:
        for path, rec in grid_paths.get(kr["name"], {}).items():
            kr.setdefault("by_path", {"b8_uniform": {k: kr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
            kr["by_path"][path] = rec
            kr["max_abs_err"] = max(kr["max_abs_err"], rec["max_abs_err"])
    torch.cuda.empty_cache()

    log(f"phase 16: the published MaskFiner-UpDown-Mini ({UPDOWN}, MaskFinerOracleTeacherBB; one "
        f"block a stage) at {SIZE}x{SIZE}: the token stream, K1, K3 and K9 on a batch-{BATCH} forward's operands, "
        "the forward against the plain versions, K2, K4, K10, K12 and K13 on a real step's "
        f"operands, {UPDOWN_STEPS} steps at batch {BATCH} each replayed through the plain "
        f"versions, test() on {len(UPDOWN_EVAL_SIZES)} ADE20K-shaped images and under "
        "MaskFinerOracleTeacherSW")
    t16 = time.time()
    updown_paths, updown_launches_ = updown_phase(dev, smi, gen,
                                                  {**train_counters, **layout_counters},
                                                  UPDOWN_DEPTHS)
    log(f"  phase 16 took {time.time() - t16:.1f} s")
    for kr in kernels:
        for path, rec in updown_paths.get(kr["name"], {}).items():
            kr.setdefault("by_path", {"b8_uniform": {k: kr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
            kr["by_path"][path] = rec
            kr["max_abs_err"] = max(kr["max_abs_err"], rec["max_abs_err"])
    torch.cuda.empty_cache()

    log(f"phase 17: the last two families at {SIZE}x{SIZE}, published widths, one block a "
        f"stage: {OT} (MaskFinerOracleTeacher) and "
        f"{MRMLNB} (MaskFormerML over MixResMetaLossNeighbour), each with K1, K3 and K9 on a "
        f"batch-{BATCH} forward's operands, the forward against the plain versions, K2, K4, "
        f"K10, the ranking's read and K13 on a real step's operands, {FAMILY_STEPS} steps at "
        f"batch {BATCH} each replayed through the plain versions and test() on "
        f"{len(FAMILY_EVAL_SIZES)} ADE20K-shaped images; {MRML} and {MRMEAN} (global "
        "attention) a forward and a step each, against the plain versions")
    t17 = time.time()
    family_paths, family_launches_ = families_phase(dev, smi, gen,
                                                    {**train_counters, **layout_counters},
                                                    opts=FAMILY_DEPTHS)
    log(f"  phase 17 took {time.time() - t17:.1f} s")
    for kr in kernels:
        for path, rec in family_paths.get(kr["name"], {}).items():
            kr.setdefault("by_path", {"b8_uniform": {k: kr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
            kr["by_path"][path] = rec
            kr["max_abs_err"] = max(kr["max_abs_err"], rec["max_abs_err"])
    torch.cuda.empty_cache()

    log(f"phase 19: bf16 mixed precision (SOLVER.AMP.ENABLED) at the published {AMP_PRESET} "
        f"(MaskFinerOracleTeacherBB), full width, {AMP_SIZE}x{AMP_SIZE}, batch {AMP_BATCH}: K1, "
        "K3 and K9 on an AMP forward's operands, the AMP forward against the plain versions, K2, "
        f"K4, K10, K12 and K13 on a real AMP step's operands, {AMP_STEPS} AMP steps each "
        "replayed through the plain versions and against the same steps in fp32, test() with "
        f"PQ on {len(AMP_EVAL_SIZES)} COCO-shaped images")
    t19 = time.time()
    amp_paths, amp_launches_ = amp_phase(dev, smi, gen, {**train_counters, **layout_counters})
    log(f"  phase 19 took {time.time() - t19:.1f} s")
    for kr in kernels:
        for path, rec in amp_paths.get(kr["name"], {}).items():
            kr.setdefault("by_path", {"b8_uniform": {k: kr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
            kr["by_path"][f"{AMP_PRESET}_{path}"] = rec
            kr["max_abs_err"] = max(kr["max_abs_err"], rec["max_abs_err"])
    torch.cuda.empty_cache()

    log(f"phase 20: the published yamls read by the port's own reader and driven through "
        f"train_net --config-file at their published widths: "
        + ", ".join(f"{label} (batch {b})" for label, _, b, _, _, _ in YAML_RUNS)
        + f"; {YAML_STEPS} steps each, a forward against the plain versions, a step's device "
        "busy time, the demo on an image of the yaml's test size, the analysis' parameter count, "
        "the sliding-window test() on one 1024x2048 image; "
        + ", ".join(label for label, *_, hold in YAML_RUNS if hold)
        + ": K1, K3 and K9 on a forward's operands, K2, K4, K10, the ranking's read and K13 on "
        "a real step's")
    t20 = time.time()
    yaml_paths, yaml_launches_ = yaml_phase(dev, smi, gen, {**train_counters, **layout_counters})
    log(f"  phase 20 took {time.time() - t20:.1f} s")
    for kr in kernels:
        for path, rec in yaml_paths.get(kr["name"], {}).items():
            kr.setdefault("by_path", {"b8_uniform": {k: kr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
            kr["by_path"][path] = rec
            kr["max_abs_err"] = max(kr["max_abs_err"], rec["max_abs_err"])
    torch.cuda.empty_cache()

    log(f"phase 21: data parallelism: {DIST_RANKS} ranks on the one card (gloo, an explicit "
        f"device map) each take {DIST_STEPS} {DIST_PRESET} steps at {SIZE}x{SIZE}, batch "
        f"{DIST_LOCAL_BATCH}, through Trainer / TrainStep (DistributedDataParallel, global "
        f"BatchNorm statistics, the global criterion) against one process's {DIST_STEPS} steps "
        f"on the global batch of {DIST_RANKS * DIST_LOCAL_BATCH}, replaying its choices; then "
        f"train_net under WORLD_SIZE=1 (NCCL) for {DIST_STEPS} steps and --eval-only on "
        f"{len(DIST_EVAL_SIZES)} images")
    t21 = time.time()
    _, dist_launches = distributed_phase(dev, smi, train_counters)
    log(f"  phase 21 took {time.time() - t21:.1f} s")
    torch.cuda.empty_cache()

    log(f"phase 22: what the ported models once refused or ignored: (a) the JAX package's flagship "
        f"(MASK_FORMER.DROPOUT 0.1, CONVS_DIM 128) trained as bench.py trains it, AMP, "
        f"{DROPOUT_SIZE}x{DROPOUT_SIZE}, batch {DROPOUT_BATCH}, {DROPOUT_STEPS} steps; (b) "
        "AFF-Mini without the reserved grid, clusters of 64 over neighbourhoods of 48, one block "
        "a stage: K1, K3, K9, K2, K4, K10, K12, K13 on its operands, a step; (c) MaskFiner-Mini "
        "one block a stage with the pre-norm Cat decoder, MASK_DECODER_ALL_LEVELS, a HierUp last "
        "stage and the stage dropouts at 0.1, a step; every step replayed through the plain "
        "versions and each Dropout's kept share held")
    t22 = time.time()
    dropout_paths, dropout_launches = dropout_phase(dev, smi, gen, train_counters)
    log(f"  phase 22 took {time.time() - t22:.1f} s")
    for kr in kernels:
        for path, rec in dropout_paths.get(kr["name"], {}).items():
            kr.setdefault("by_path", {"b8_uniform": {k: kr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
            kr["by_path"][path] = rec
            kr["max_abs_err"] = max(kr["max_abs_err"], rec["max_abs_err"])
    torch.cuda.empty_cache()

    log("phase 23: the stages and backends once refused: (a) MaskFiner-Mini at its published "
        f"widths with MR.NAME {XATTN_NAMES}: K1, K3 and K9 on a batch-{XATTN_BATCH} forward's "
        "operands, the forward against the plain versions, one Trainer step replayed through "
        "them; (b) a MixResNeighbour first stage, one block a stage, a forward against the plain "
        "versions; (c) maskfiner_dynamic_eval at the static ratio and at the default buckets; "
        "(d) the auction against K13 on the stacked matcher costs, the downsampled criterion on "
        f"the card against the CPU, the demo's AsyncPredictor over {ASYNC_IMAGES} images")
    t23 = time.time()
    xattn_paths, xattn_launches = xattn_phase(dev, smi, gen, train_counters)
    log(f"  phase 23 took {time.time() - t23:.1f} s")
    for kr in kernels:
        for path, rec in xattn_paths.get(kr["name"], {}).items():
            kr.setdefault("by_path", {"b8_uniform": {k: kr[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
            kr["by_path"][path] = rec
            kr["max_abs_err"] = max(kr["max_abs_err"], rec["max_abs_err"])
    torch.cuda.empty_cache()
    missing = [n for n in ("local_attn", "local_attn_bwd", "msdetrpc", "msdetrpc_bwd", "knn",
                           "point_sample", "point_sample_bwd", "point_sample_nearest",
                           "point_sample_nearest_rows", "lapjv") if not xattn_launches.get(n)]
    if missing:
        raise SystemExit(f"phase 23 never launched {missing}")

    for kr in kernels:
        names = [kr["name"]] + (["point_sample_bwd"] if kr["name"] == "point_sample" else [])
        kr["inference_launches"] = inference_launches.get(kr["name"], 0)
        kr["mini_step_launches"] = sum(mini_launches.get(n, 0) for n in names)
        kr["small_run_launches"] = sum(small_launches.get(n, 0) + k11_launches.get(n, 0)
                                       for n in names)
        # on the layouts' and the 1/5 preset's forwards and steps; a sampling
        # kernel's backward counts with it, as its TPU function holds both
        with_bwd = names + [kr["name"] + "_bwd"] if kr["name"] in SAMPLING else names
        kr["layouts_launches"] = sum(layout_launches.get(n, 0) for n in with_bwd)
        kr["mini15_launches"] = sum(mini15_launches.get(n, 0) for n in with_bwd)
        kr["maskfiner_launches"] = maskfiner_fwd_launches.get(kr["name"], 0)
        # phase 12: the steps from the loader, every test() and --eval-only
        kr["eval_launches"] = sum(eval_launches.get(n, 0) for n in names)
        # phase 13: the cascade's steps, its train_net runs and their test()
        kr["maskfiner_step_launches"] = sum(mft_launches.get(n, 0) for n in names)
        # phase 14: the panoptic and instance runs' steps and test()
        kr["panoptic_instance_launches"] = sum(pi_launches.get(n, 0) for n in names)
        # phase 15: the grid baselines' forwards, steps and test()
        kr["grid_launches"] = sum(grid_launches_.get(n, 0) for n in names)
        # phase 16: the OracleTeacher-BB cascade's forwards, steps and test()
        kr["updown_launches"] = sum(updown_launches_.get(n, 0) for n in names)
        # phase 17: the OracleTeacher and MRML models' forwards, steps and test()
        kr["family_launches"] = sum(family_launches_.get(n, 0) for n in names)
        # phase 19: the AMP UpDown-Tiny's forwards, steps and test()
        kr["amp_launches"] = sum(amp_launches_.get(n, 0) for n in names)
        # phase 20: the published yamls' train_net runs, forwards, steps, demos and test()
        kr["yaml_launches"] = sum(yaml_launches_.get(n, 0) for n in names)
        # phase 21: the one-process and both ranks' steps, the NCCL train_net
        # run and its --eval-only
        kr["distributed_launches"] = sum(dist_launches.get(n, 0) for n in names)
        # phase 22: the flagship's steps, the unreserved span-64 AFF's and the
        # MaskFiner options' steps and replays
        kr["dropout_launches"] = sum(dropout_launches.get(n, 0) for n in names)
        # phase 23: the XAttn / ConvNeXtV2 cascade's forward and step, the
        # MixResNeighbour-first forward, the dynamic evals and the demo's calls
        kr["xattn_launches"] = sum(xattn_launches.get(n, 0) for n in names)
        kr["launches"] = (kr["inference_launches"] + kr["mini_step_launches"]
                          + kr["small_run_launches"] + kr["layouts_launches"]
                          + kr["mini15_launches"] + kr["maskfiner_launches"]
                          + kr["eval_launches"] + kr["maskfiner_step_launches"]
                          + kr["panoptic_instance_launches"] + kr["grid_launches"]
                          + kr["updown_launches"] + kr["family_launches"]
                          + kr["amp_launches"] + kr["yaml_launches"]
                          + kr["distributed_launches"] + kr["dropout_launches"]
                          + kr["xattn_launches"])
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
