"""Neighbourhood gather-einsums (counterparts of ``autofocusformermod_tpu/ops/clusten.py``).

Plain PyTorch: gather the neighbour rows, then contract.  These are the
semantic definitions the kernels are held against.  ``msdetrpc``, the
interleaved deformable sampling, launches its CUDA kernels on CUDA tensors:
the forward and the fixed-order backward pair that every msdetrpc layout
shares (``csrc/msdetrpc.cu``; counterpart of
``autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:msdetrpc_pallas``),
with the attention as each slot's second weight.
"""

from __future__ import annotations

import ctypes

import torch

from ..dtypes import promoted
from .build import check, load_kernels
from .dispatch import require, stream_of, use_kernel
from .gather import take_rows
from .msdetrpc import bwd_scratch


def _gather_tokens_h(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat: (b, h, n, c), idx: (b, n_, m) shared across heads -> (b, h, n_, m, c)."""
    b, h, n, c = feat.shape
    g = take_rows(feat.reshape(b * h, n, c),
                  idx.unsqueeze(1).expand(b, h, *idx.shape[1:]).reshape(b * h, *idx.shape[1:]))
    return g.reshape(b, h, *idx.shape[1:], c)


def cluster_qk(query: torch.Tensor, key: torch.Tensor, nbhd_idx: torch.Tensor) -> torch.Tensor:
    """attn[b,h,i,m] = sum_c q[b,h,i,c] * k[b,h,nbhd_idx[b,i,m],c] -> (b, h, n, m)."""
    return torch.einsum("bhnc,bhnmc->bhnm", query, _gather_tokens_h(key, nbhd_idx))


def cluster_av(attn: torch.Tensor, v: torch.Tensor, nbhd_idx: torch.Tensor) -> torch.Tensor:
    """feat[b,h,i,c] = sum_m attn[b,h,i,m] * v[b,h,nbhd_idx[b,i,m],c] -> (b, h, n, c)."""
    return torch.einsum("bhnm,bhnmc->bhnc", attn, _gather_tokens_h(v, nbhd_idx))


def cluster_wf(weights: torch.Tensor, feat: torch.Tensor, nbhd_idx: torch.Tensor) -> torch.Tensor:
    """weights: (b, n_, m, ic); feat: (b, n, c); nbhd_idx: (b, n_, m) -> (b, n_, ic, c)."""
    return torch.einsum("bnmi,bnmc->bnic", *promoted(weights, take_rows(feat, nbhd_idx)))


def weighted_gather(nbhd_idx: torch.Tensor, weights: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """nbhd_idx/weights: (b, n_, m); feat: (b, n, c) -> (b, n_, c), in the
    two operands' common dtype."""
    return torch.einsum("bnm,bnmc->bnc", *promoted(weights, take_rows(feat, nbhd_idx)))


def msdetrpc(nn_idx: torch.Tensor, nn_weight: torch.Tensor, attn: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """feat[b,i,c] = sum_m attn[b,i,m] * sum_k w[b,i,m,k] * val[b,nn_idx[b,i,m,k],c].

    nn_idx/nn_weight: (b, n, m, k); attn: (b, n, m); val: (b, nv, c) -> (b, n, c).
    On CUDA tensors (nn_idx int32, the rest f32, all contiguous) an autograd
    Function over the interleaved kernels, differentiable in nn_weight, attn
    and val; on CPU tensors the plain version.
    """
    if not use_kernel(nn_idx, nn_weight, attn, val):
        return msdetrpc_plain(nn_idx, nn_weight, attn, val)
    return _MsdetrpcInterleaved.apply(nn_idx, nn_weight, attn, val)


def msdetrpc_plain(nn_idx, nn_weight, attn, val) -> torch.Tensor:
    """Plain version: fold the attention into the weights, gather, contract."""
    w = nn_weight * attn[..., None]
    return torch.einsum("bnmk,bnmkc->bnc", w, take_rows(val, nn_idx))


class _MsdetrpcInterleaved(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nn_idx, nn_weight, attn, val):
        ctx.save_for_backward(nn_idx, nn_weight, attn, val)
        return msdetrpc_forward(nn_idx, nn_weight, attn, val)

    @staticmethod
    def backward(ctx, g):
        return (None, *msdetrpc_backward(*ctx.saved_tensors, g.contiguous()))


def _check_interleaved(nn_idx, nn_weight, attn, val):
    bh, n, m, k = nn_idx.shape
    nv, c = val.shape[1:]
    require(nn_idx, "nn_idx", torch.int32, (bh, n, m, k))
    require(nn_weight, "nn_weight", torch.float32, (bh, n, m, k))
    require(attn, "attn", torch.float32, (bh, n, m))
    require(val, "val", torch.float32, (bh, nv, c))
    return bh, n, nv, c, m, k


def msdetrpc_forward(nn_idx, nn_weight, attn, val) -> torch.Tensor:
    """Launch the interleaved forward kernel -> (bh, n, c)."""
    dims = _check_interleaved(nn_idx, nn_weight, attn, val)
    out = torch.empty((dims[0], dims[1], dims[3]), dtype=torch.float32, device=val.device)
    lib = load_kernels()
    with torch.cuda.device(val.device):
        err = lib.aff_msdetrpc_interleaved(nn_idx.data_ptr(), nn_weight.data_ptr(),
                                           attn.data_ptr(), val.data_ptr(), out.data_ptr(),
                                           *dims, stream_of(val))
    check(err, "aff_msdetrpc_interleaved")
    msdetrpc.launches += 1
    return out


msdetrpc.launches = 0


def msdetrpc_backward(nn_idx, nn_weight, attn, val, g):
    """Launch the interleaved backward kernels for g = d out (bh, n, c) ->
    (d_nn_weight, d_attn, d_val), each shaped as its operand.  No atomics:
    two calls on the same inputs return the same bits.  One launch is counted
    per call, both kernels together."""
    dims = _check_interleaved(nn_idx, nn_weight, attn, val)
    bh, n, ntot, c, m, k = dims
    require(g, "g", torch.float32, (bh, n, c))
    lib = load_kernels()
    scratch = bwd_scratch(lib, (ctypes.c_int * 1)(ntot), m * k, bh, n, c, val.device)
    d_w, d_attn, d_val = torch.empty_like(nn_weight), torch.empty_like(attn), torch.empty_like(val)
    with torch.cuda.device(val.device):
        err = lib.aff_msdetrpc_interleaved_bwd(
            nn_idx.data_ptr(), nn_weight.data_ptr(), attn.data_ptr(), val.data_ptr(),
            g.data_ptr(), d_w.data_ptr(), d_attn.data_ptr(), d_val.data_ptr(),
            *(t.data_ptr() for t in scratch), *dims, stream_of(val))
    check(err, "aff_msdetrpc_interleaved_bwd")
    msdetrpc_backward.launches += 1
    return d_w, d_attn, d_val


msdetrpc_backward.launches = 0
