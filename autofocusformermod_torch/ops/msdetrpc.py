"""Deformable point sampling: the ``msdetrpc`` CUDA kernels
(``csrc/msdetrpc.cu``, forward and backward) in four operand layouts, and
their plain PyTorch versions.

Counterpart of ``autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py``.  All
compute ``out[q] = sum_j sum_p w_j[q, p] * val[off_j + idx_j[q, p]]`` over the
levels j with level-LOCAL indices; they differ in where the operands lie:

- ``msdetrpc_levels_s`` (``msdetrpc_pallas_levels_s``): one (bh, n, L*P)
  array, the levels stacked on the pair axis -- the pixel decoder's default;
- ``msdetrpc_levels`` (``msdetrpc_pallas_levels``): one (bh, n, P) array per
  level;
- ``msdetrpc_levels_t`` (``msdetrpc_pallas_levels_t``): per level (bh, P, n),
  queries minor;
- ``msdetrpc_bh`` (``msdetrpc_pallas_bh``): per level (b, n, h, P), values
  (b, ntot, h, c_), result (b, n, h, c_), heads where the Linear put them.

One forward kernel and one backward pair (``csrc/msdetrpc.cu``) serve the
four layouts, each read in place, and the interleaved fifth,
``ops/clusten.py:msdetrpc``.  On CUDA tensors each call is an autograd
Function differentiable in the weights and the values (the indices get no
gradient), whose backward writes d_val and d_w without atomics, in a fixed
order: two calls on the same inputs return the same bits.  On CPU tensors
the plain version runs.  ``msdetrpc_levels_s_library`` computes the
stacked layout's function with one PyTorch call (``F.embedding_bag``), as a
yardstick of the kernels' speed; nothing in the port calls it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .build import check, load_kernels
from .dispatch import require, stream_of, use_kernel
from .gather import take_rows


def msdetrpc_levels_s(idx_s: torch.Tensor, w_s: torch.Tensor, val: torch.Tensor,
                      level_sizes: Sequence[int]) -> torch.Tensor:
    """out[r,q,:] = sum_j sum_p w_s[r,q,j*P+p] * val[r, off_j + idx_s[r,q,j*P+p], :].

    idx_s: (bh, n, L*P) int32 level-LOCAL indices, level j in columns
    [j*P, (j+1)*P); w_s: (bh, n, L*P) f32; val: (bh, ntot, c_) f32 with
    ntot = sum(level_sizes).  Returns (bh, n, c_).
    """
    if not use_kernel(idx_s, w_s, val):
        return msdetrpc_levels_s_plain(idx_s, w_s, val, level_sizes)
    return _Msdetrpc.apply(idx_s, w_s, val, tuple(int(s) for s in level_sizes))


class _Msdetrpc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx_s, w_s, val, level_sizes):
        ctx.save_for_backward(idx_s, w_s, val)
        ctx.level_sizes = level_sizes
        return msdetrpc_forward(idx_s, w_s, val, level_sizes)

    @staticmethod
    def backward(ctx, g):
        idx_s, w_s, val = ctx.saved_tensors
        d_val, d_w = msdetrpc_levels_s_backward(idx_s, w_s, val, g.contiguous(),
                                                ctx.level_sizes)
        return None, d_w, d_val, None


def _check_operands(idx_s, w_s, val, level_sizes):
    bh, n, lp = idx_s.shape
    ntot, c_ = val.shape[1:]
    n_levels = len(level_sizes)
    if lp % n_levels or sum(level_sizes) != ntot:
        raise ValueError(f"pairs {lp} / levels {tuple(level_sizes)} / ntot {ntot} disagree")
    require(idx_s, "idx_s", torch.int32, (bh, n, lp))
    require(w_s, "w_s", torch.float32, (bh, n, lp))
    require(val, "val", torch.float32, (bh, ntot, c_))
    sizes = (ctypes.c_int * n_levels)(*(int(s) for s in level_sizes))
    return bh, n, lp, ntot, c_, n_levels, sizes


def msdetrpc_forward(idx_s, w_s, val, level_sizes: Sequence[int]) -> torch.Tensor:
    """Launch the forward kernel -> (bh, n, c_)."""
    bh, n, lp, ntot, c_, n_levels, sizes = _check_operands(idx_s, w_s, val, level_sizes)
    out = torch.empty((bh, n, c_), dtype=torch.float32, device=val.device)
    lib = load_kernels()
    with torch.cuda.device(val.device):
        err = lib.aff_msdetrpc(
            idx_s.data_ptr(), w_s.data_ptr(), val.data_ptr(), out.data_ptr(),
            bh, n, ntot, c_, n_levels, ctypes.cast(sizes, ctypes.c_void_p),
            lp // n_levels, stream_of(val))
    check(err, "aff_msdetrpc")
    msdetrpc_levels_s.launches += 1
    return out


msdetrpc_levels_s.launches = 0


def msdetrpc_levels_s_backward(idx_s, w_s, val, g, level_sizes: Sequence[int]):
    """Launch the backward kernels for g = d out (bh, n, c_) -> (d_val (bh,
    ntot, c_), d_w (bh, n, L*P)).  No atomics: two calls on the same inputs
    return the same bits.  One launch is counted per call, both kernels
    together."""
    bh, n, lp, ntot, c_, n_levels, sizes = _check_operands(idx_s, w_s, val, level_sizes)
    require(g, "g", torch.float32, (bh, n, c_))
    lib = load_kernels()
    scratch = bwd_scratch(lib, sizes, lp // n_levels, bh, n, c_, val.device)
    d_val = torch.empty_like(val)
    d_w = torch.empty_like(w_s)
    with torch.cuda.device(val.device):
        err = lib.aff_msdetrpc_bwd(
            idx_s.data_ptr(), w_s.data_ptr(), val.data_ptr(), g.data_ptr(), d_val.data_ptr(),
            d_w.data_ptr(), *(t.data_ptr() for t in scratch), bh, n, ntot, c_, n_levels,
            ctypes.cast(sizes, ctypes.c_void_p), lp // n_levels, stream_of(val))
    check(err, "aff_msdetrpc_bwd")
    msdetrpc_levels_s_backward.launches += 1
    return d_val, d_w


msdetrpc_levels_s_backward.launches = 0


def bwd_scratch(lib, sizes, pairs, units, n, c_, dev):
    """The backward's scratch for `units` image-heads of n queries, as
    aff_msdetrpc_bwd_scratch sizes it: the query tiles' partial rows and
    their row ids (a tile writes only what it needs of its part), and where
    each band of value rows starts in them.  sizes: the level sizes as a C
    array."""
    dims = (ctypes.c_int * 3)()
    check(lib.aff_msdetrpc_bwd_scratch(n, len(sizes), ctypes.cast(sizes, ctypes.c_void_p), pairs,
                                       ctypes.cast(dims, ctypes.c_void_p)),
          "aff_msdetrpc_bwd_scratch")
    tiles, rows, starts = dims
    return (torch.empty((units * tiles * rows,), dtype=torch.int32, device=dev),
            torch.empty((units * tiles * rows, c_), dtype=torch.float32, device=dev),
            torch.empty((units * tiles * starts,), dtype=torch.int32, device=dev))


def msdetrpc_levels_s_plain(idx_s, w_s, val, level_sizes: Sequence[int]) -> torch.Tensor:
    """Plain version: shift level-local indices to global rows, gather, contract."""
    lp = idx_s.shape[2]
    p = lp // len(level_sizes)
    offs = torch.repeat_interleave(
        torch.cumsum(torch.tensor([0] + list(level_sizes[:-1]), device=idx_s.device), 0),
        p)
    rows = take_rows(val, idx_s.long() + offs)                  # (bh, n, L*P, c_)
    return torch.einsum("bnp,bnpc->bnc", w_s, rows)


def msdetrpc_bag_rows(idx_s: torch.Tensor, level_sizes: Sequence[int]) -> torch.Tensor:
    """The value rows of ``msdetrpc_levels_s``'s pairs in the flattened (bh *
    ntot, c_) table: (bh * n, L*P) int64, r * ntot + off_j + the index clamped
    into level j (as the kernel clamps it)."""
    bh, n, lp = idx_s.shape
    p = lp // len(level_sizes)
    dev = idx_s.device
    sizes = torch.tensor(list(level_sizes), device=dev)
    offs = torch.repeat_interleave(torch.cumsum(sizes, 0) - sizes, p)
    local = torch.minimum(idx_s.long().clamp(min=0), torch.repeat_interleave(sizes - 1, p))
    heads = torch.arange(bh, device=dev)[:, None, None] * int(sizes.sum())
    return (local + offs + heads).reshape(bh * n, lp)


def msdetrpc_levels_s_library(idx_s, w_s, val, level_sizes: Sequence[int],
                              rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``msdetrpc_levels_s`` as one PyTorch call: ``F.embedding_bag`` in sum
    mode with ``w_s`` as the per-sample weights, one bag of L*P rows per
    query, over the flattened table; its autograd backward gives d_val and
    d_w.  The port runs it nowhere: it is the library yardstick of the
    stacked forward and backward kernels.  ``rows``: ``msdetrpc_bag_rows``
    made ahead, to time the call alone."""
    bh, n, lp = idx_s.shape
    ntot, c_ = val.shape[1:]
    if rows is None:
        rows = msdetrpc_bag_rows(idx_s, level_sizes)
    out = F.embedding_bag(rows, val.reshape(bh * ntot, c_), mode="sum",
                          per_sample_weights=w_s.reshape(bh * n, lp))
    return out.reshape(bh, n, c_)


# --------------------------------------------------- per-level operand layouts
MAX_LEVELS = 8          # csrc/msdetrpc.cu kMaxLevels


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check_level_operands(idxs, ws, val, level_sizes, op_shape, val_shape):
    """Common checks of the per-level layouts -> (level sizes as a C array,
    L); op_shape: every idx and w; val_shape: val."""
    n_levels = len(level_sizes)
    if not (len(idxs) == len(ws) == n_levels):
        raise ValueError(f"{len(idxs)} idx and {len(ws)} w arrays for {n_levels} levels")
    if n_levels > MAX_LEVELS:
        raise ValueError(f"the kernel takes at most {MAX_LEVELS} levels, got {n_levels}")
    if sum(level_sizes) != val_shape[1]:
        raise ValueError(f"levels {tuple(level_sizes)} do not sum to ntot {val_shape[1]}")
    for j, (i, w) in enumerate(zip(idxs, ws)):
        require(i, f"idxs[{j}]", torch.int32, op_shape)
        require(w, f"ws[{j}]", torch.float32, op_shape)
    require(val, "val", torch.float32, val_shape)
    return (ctypes.c_int * n_levels)(*(int(s) for s in level_sizes)), n_levels


class _Layout:
    """One per-level layout: its C entry points, its plain version, and
    ``shapes(idx0, val)`` -> (the launcher's ints before n_levels, pairs,
    shape of every idx and w, shape of val, shape of the result).  The
    result is (units, n, c_) rows with the units (image-heads) split over
    its other axes."""

    def __init__(self, name, entry, shapes, plain):
        self.name, self.entry, self.shapes, self.plain = name, entry, shapes, plain

    def _launch(self, entry, idxs, ws, val, level_sizes, tensors, extra=()):
        """Check the operands and call entry(idxs, ws, val, *tensors, *extra, ints...)."""
        ints, pairs, op_shape, val_shape, out_shape = self.shapes(idxs[0], val)
        sizes, n_levels = _check_level_operands(idxs, ws, val, level_sizes, op_shape, val_shape)
        require(tensors[0], "out" if entry == self.entry else "g", torch.float32, out_shape)
        keep = [_pointers(idxs), _pointers(ws), *(_pointers(e) for e in extra)]
        lib = load_kernels()
        with torch.cuda.device(val.device):
            err = getattr(lib, entry)(
                ctypes.cast(keep[0], ctypes.c_void_p), ctypes.cast(keep[1], ctypes.c_void_p),
                val.data_ptr(), *(t.data_ptr() for t in tensors),
                *(ctypes.cast(k, ctypes.c_void_p) for k in keep[2:]),
                *ints, n_levels, ctypes.cast(sizes, ctypes.c_void_p), pairs, stream_of(val))
        check(err, entry)

    def forward(self, idxs, ws, val, level_sizes):
        out = torch.empty(self.shapes(idxs[0], val)[4], dtype=torch.float32, device=val.device)
        self._launch(self.entry, idxs, ws, val, level_sizes, (out,))
        return out

    def backward(self, idxs, ws, val, g, level_sizes):
        """g = d out in the result's layout -> (d_val in val's layout, one
        d_w per level in its w's layout), every element written by the
        kernels, in a fixed order."""
        _, pairs, _, _, out_shape = self.shapes(idxs[0], val)
        n, c_ = out_shape[1], out_shape[-1]
        sizes = (ctypes.c_int * len(level_sizes))(*(int(s) for s in level_sizes))
        scratch = bwd_scratch(load_kernels(), sizes, pairs, math.prod(out_shape) // (n * c_), n,
                               c_, val.device)
        d_val = torch.empty_like(val)
        d_ws = [torch.empty_like(w) for w in ws]
        self._launch(self.entry + "_bwd", idxs, ws, val, level_sizes, (g, d_val, *scratch),
                     (d_ws,))
        return d_val, d_ws


class _LayoutFunction(torch.autograd.Function):
    """apply(wrapper, level_sizes, val, *idxs, *ws): the wrapper's forward
    launcher, and its backward launcher for d_val and one d_w per level."""

    @staticmethod
    def forward(ctx, wrapper, level_sizes, val, *ops):
        n_levels = len(level_sizes)
        idxs, ws = ops[:n_levels], ops[n_levels:]
        ctx.save_for_backward(val, *ops)
        ctx.wrapper, ctx.level_sizes = wrapper, level_sizes
        return wrapper.forward_launcher(idxs, ws, val, level_sizes)

    @staticmethod
    def backward(ctx, g):
        val, *ops = ctx.saved_tensors
        n_levels = len(ctx.level_sizes)
        d_val, d_ws = ctx.wrapper.backward_launcher(ops[:n_levels], ops[n_levels:], val,
                                                    g.contiguous(), ctx.level_sizes)
        return (None, None, d_val) + (None,) * n_levels + tuple(d_ws)


def _offsets(level_sizes):
    return [sum(level_sizes[:j]) for j in range(len(level_sizes))]


def msdetrpc_levels_plain(idxs, ws, val, level_sizes: Sequence[int]) -> torch.Tensor:
    """Plain version of ``msdetrpc_levels``:
    out[r, q, :] = sum_j sum_p ws[j][r, q, p] * val[r, off_j + idxs[j][r, q, p], :]."""
    out = 0
    for off, idx, w in zip(_offsets(level_sizes), idxs, ws):        # (bh, n, P)
        out = out + torch.einsum("rqp,rqpc->rqc", w, take_rows(val, idx.long() + off))
    return out


def msdetrpc_levels_t_plain(idx_ts, w_ts, val, level_sizes: Sequence[int]) -> torch.Tensor:
    """Plain version of ``msdetrpc_levels_t``:
    out[r, q, :] = sum_j sum_p w_ts[j][r, p, q] * val[r, off_j + idx_ts[j][r, p, q], :]."""
    out = 0
    for off, idx, w in zip(_offsets(level_sizes), idx_ts, w_ts):    # (bh, P, n)
        out = out + torch.einsum("rpq,rpqc->rqc", w, take_rows(val, idx.long() + off))
    return out


def msdetrpc_bh_plain(idxs, ws, val, level_sizes: Sequence[int]) -> torch.Tensor:
    """Plain version of ``msdetrpc_bh``: out[b, q, h, :] =
    sum_j sum_p ws[j][b, q, h, p] * val[b, off_j + idxs[j][b, q, h, p], h, :]."""
    b, ntot, h, c_ = val.shape
    heads = torch.arange(h, device=val.device)[None, None, :, None]
    rows = val.reshape(b, ntot * h, c_)                              # row t * h + head
    out = 0
    for off, idx, w in zip(_offsets(level_sizes), idxs, ws):        # (b, n, h, P)
        picked = take_rows(rows, (idx.long() + off) * h + heads)    # (b, n, h, P, c_)
        out = out + torch.einsum("bqhp,bqhpc->bqhc", w, picked)
    return out


def _levels_shapes(idx0, val):
    (bh, n, p), (ntot, c_) = idx0.shape, val.shape[1:]
    return (bh, n, ntot, c_), p, (bh, n, p), (bh, ntot, c_), (bh, n, c_)


def _levels_t_shapes(idx0, val):
    (bh, p, n), (ntot, c_) = idx0.shape, val.shape[1:]
    return (bh, n, ntot, c_), p, (bh, p, n), (bh, ntot, c_), (bh, n, c_)


def _bh_shapes(idx0, val):
    (b, n, h, p), (ntot, c_) = idx0.shape, (val.shape[1], val.shape[3])
    return (b, n, h, ntot, c_), p, (b, n, h, p), (b, ntot, h, c_), (b, n, h, c_)


_LEVELS = _Layout("msdetrpc_levels", "aff_msdetrpc_levels", _levels_shapes, msdetrpc_levels_plain)
_LEVELS_T = _Layout("msdetrpc_levels_t", "aff_msdetrpc_levels_t", _levels_t_shapes,
                    msdetrpc_levels_t_plain)
_BH = _Layout("msdetrpc_bh", "aff_msdetrpc_bh", _bh_shapes, msdetrpc_bh_plain)


def _make_wrapper(layout: _Layout, doc: str):
    """The public function of one layout, with its launch counters:
    wrapper.launches, wrapper.backward_launcher.launches."""

    def forward_launcher(idxs, ws, val, level_sizes):
        out = layout.forward(idxs, ws, val, level_sizes)
        wrapper.launches += 1
        return out

    def backward_launcher(idxs, ws, val, g, level_sizes):
        grads = layout.backward(idxs, ws, val, g, level_sizes)
        backward_launcher.launches += 1
        return grads

    def wrapper(idxs, ws, val, level_sizes: Sequence[int]) -> torch.Tensor:
        idxs, ws = tuple(idxs), tuple(ws)
        if not use_kernel(val, *idxs, *ws):
            return layout.plain(idxs, ws, val, level_sizes)
        return _LayoutFunction.apply(wrapper, tuple(int(s) for s in level_sizes), val,
                                     *idxs, *ws)

    wrapper.__name__ = wrapper.__qualname__ = layout.name
    wrapper.__doc__ = doc
    backward_launcher.__name__ = backward_launcher.__qualname__ = layout.name + "_backward"
    backward_launcher.__doc__ = (f"Launch the backward kernel of ``{layout.name}`` for g = d out "
                                 "-> (d_val, [d_w per level]), each in its operand's layout.")
    wrapper.launches = backward_launcher.launches = 0
    wrapper.forward_launcher, wrapper.backward_launcher = forward_launcher, backward_launcher
    return wrapper, backward_launcher


msdetrpc_levels, msdetrpc_levels_backward = _make_wrapper(_LEVELS, """\
out[r,q,:] = sum_j sum_p ws[j][r,q,p] * val[r, off_j + idxs[j][r,q,p], :].

    idxs: per level (bh, n, P) int32 level-LOCAL indices; ws: per level
    (bh, n, P) f32; val: (bh, ntot, c_) f32, ntot = sum(level_sizes).
    Returns (bh, n, c_).  At most 8 levels.""")
msdetrpc_levels_t, msdetrpc_levels_t_backward = _make_wrapper(_LEVELS_T, """\
out[r,q,:] = sum_j sum_p w_ts[j][r,p,q] * val[r, off_j + idx_ts[j][r,p,q], :].

    idx_ts: per level (bh, P, n) int32 level-LOCAL indices, queries minor;
    w_ts: per level (bh, P, n) f32; val: (bh, ntot, c_) f32.  Returns
    (bh, n, c_).  At most 8 levels.""")
msdetrpc_bh, msdetrpc_bh_backward = _make_wrapper(_BH, """\
out[b,q,h,:] = sum_j sum_p ws[j][b,q,h,p] * val[b, off_j + idxs[j][b,q,h,p], h, :].

    idxs: per level (b, n, h, P) int32 level-LOCAL indices; ws: per level
    (b, n, h, P) f32; val: (b, ntot, h, c_) f32.  Returns (b, n, h, c_).
    At most 8 levels.""")
