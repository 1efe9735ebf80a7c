"""Deformable point sampling over stacked levels: the ``msdetrpc`` CUDA
kernels (``csrc/msdetrpc.cu``, forward and backward) and their plain PyTorch
version.

Counterpart of ``autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py``
(``msdetrpc_pallas_levels_s`` and its VJP
``msdetrpc_pallas_levels_s_bwd_impl``), returning the natural (bh, n, c_)
layout.  On CUDA tensors the call is an autograd Function differentiable in
the weights and the values (the indices get no gradient).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

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
    """Launch the backward kernel for g = d out (bh, n, c_) -> (d_val (bh,
    ntot, c_), d_w (bh, n, L*P))."""
    bh, n, lp, ntot, c_, n_levels, sizes = _check_operands(idx_s, w_s, val, level_sizes)
    require(g, "g", torch.float32, (bh, n, c_))
    d_val = torch.zeros_like(val)
    d_w = torch.empty_like(w_s)
    lib = load_kernels()
    with torch.cuda.device(val.device):
        err = lib.aff_msdetrpc_bwd(
            idx_s.data_ptr(), w_s.data_ptr(), val.data_ptr(), g.data_ptr(), d_val.data_ptr(),
            d_w.data_ptr(), bh, n, ntot, c_, n_levels, ctypes.cast(sizes, ctypes.c_void_p),
            lp // n_levels, stream_of(val))
    check(err, "aff_msdetrpc_bwd")
    msdetrpc_levels_s_backward.launches += 1
    return d_val, d_w


msdetrpc_levels_s_backward.launches = 0


def msdetrpc_levels_s_plain(idx_s, w_s, val, level_sizes: Sequence[int]) -> torch.Tensor:
    """Plain version: shift level-local indices to global rows, gather, contract."""
    lp = idx_s.shape[2]
    p = lp // len(level_sizes)
    offs = torch.repeat_interleave(
        torch.cumsum(torch.tensor([0] + list(level_sizes[:-1]), device=idx_s.device), 0),
        p)
    rows = take_rows(val, idx_s.long() + offs)                  # (bh, n, L*P, c_)
    return torch.einsum("bnp,bnpc->bnc", w_s, rows)
