"""Local cluster attention over SFC-ordered tokens: the ``local_attn`` CUDA
kernels (``csrc/local_attn.cu``, forward and backward) and their plain
PyTorch version.

Counterpart of ``autofocusformermod_tpu/ops/pallas/local_attn.py``
(``sfc_cluster_attention`` and its custom VJP ``_sfc_attention_backward``).
On CUDA tensors the call is an autograd Function: the forward kernel also
emits the row log-sum-exp, and the backward kernel recomputes the
probabilities from it.  The plain version's gradient is PyTorch's autograd
through the gather composition.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import check, load_kernels
from .dispatch import local_cluster_attention_reference, require, stream_of, use_kernel


def sfc_cluster_attention(q, k, v, pos, nc, w5, b5, blank_k,
                          cluster_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local attention of token i over the tokens of its neighbour clusters.

    q/k/v: (b, h, n, c_) f32 (q pre-scaled); pos: (b, n, 2) f32; nc: (b, n,
    nnc) int32 neighbour cluster ids (cluster c = tokens [c*cluster_size,
    (c+1)*cluster_size)); w5: (h, 5), b5: (h,) the rel-pos bias Linear;
    blank_k: (h, c_).  Returns (out (b, h, n, c_), blank_prob (b, h, n, 1)),
    differentiable in q, k, v, w5, b5 and blank_k (not in pos or nc).
    """
    if not use_kernel(q, k, v, pos, nc, w5, b5, blank_k):
        return sfc_cluster_attention_plain(q, k, v, pos, nc, w5, b5, blank_k, cluster_size)
    return _LocalAttention.apply(q, k, v, pos, nc, w5, b5, blank_k, cluster_size)


class _LocalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pos, nc, w5, b5, blank_k, cluster_size):
        out, blank, lse = local_attn_forward(q, k, v, pos, nc, w5, b5, blank_k, cluster_size)
        ctx.save_for_backward(q, k, v, pos, nc, w5, b5, blank_k, out, blank, lse)
        ctx.cluster_size = cluster_size
        return out, blank

    @staticmethod
    def backward(ctx, g, gb):
        q, k, v, pos, nc, w5, b5, blank_k, out, blank, lse = ctx.saved_tensors
        g = g.contiguous()      # an unused output's gradient arrives as zeros
        # delta = g.out + gb*p_blank; the blank sink's softmax coupling is
        # ds_blank = p_blank*(gb - delta), applied here as on the TPU (:737)
        delta = (g * out).sum(-1, keepdim=True) + gb * blank
        dsb = blank * (gb - delta)
        dq, dk, dv, drow = sfc_cluster_attention_backward(
            q, k, v, pos, nc, w5, b5, g, lse, delta.contiguous(), ctx.cluster_size)
        dq = dq + dsb * blank_k[None, :, None, :]
        dblank_k = torch.einsum("bhn,bhnc->hc", dsb[..., 0], q)
        dw5 = drow[..., :5].sum((0, 2))
        db5 = drow[..., 5].sum((0, 2))
        return dq, dk, dv, None, None, dw5, db5, dblank_k, None


def _check_operands(q, k, v, pos, nc, w5, b5):
    b, h, n, c_ = q.shape
    f32 = torch.float32
    for name, t, shape in (("q", q, (b, h, n, c_)), ("k", k, (b, h, n, c_)),
                           ("v", v, (b, h, n, c_)), ("pos", pos, (b, n, 2)),
                           ("w5", w5, (h, 5)), ("b5", b5, (h,))):
        require(t, name, f32, shape)
    require(nc, "nc", torch.int32, (b, n, nc.shape[-1]))
    return b, h, n, c_, nc.shape[-1]


def local_attn_forward(q, k, v, pos, nc, w5, b5, blank_k, cluster_size: int):
    """Launch the forward kernel -> (out, blank_prob, lse (b, h, n, 1))."""
    b, h, n, c_, nnc = _check_operands(q, k, v, pos, nc, w5, b5)
    require(blank_k, "blank_k", torch.float32, (h, c_))
    out = torch.empty_like(q)
    blank = torch.empty((b, h, n, 1), dtype=torch.float32, device=q.device)
    lse = torch.empty_like(blank)
    lib = load_kernels()
    with torch.cuda.device(q.device):
        err = lib.aff_local_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), nc.data_ptr(),
            w5.data_ptr(), b5.data_ptr(), blank_k.data_ptr(), out.data_ptr(),
            blank.data_ptr(), lse.data_ptr(), b, h, n, c_, nnc, cluster_size, stream_of(q))
    check(err, "aff_local_attn")
    sfc_cluster_attention.launches += 1
    return out, blank, lse


sfc_cluster_attention.launches = 0


def sfc_cluster_attention_backward(q, k, v, pos, nc, w5, b5, g, lse, delta,
                                   cluster_size: int):
    """Launch the backward kernel -> (dq without the blank term, dk, dv,
    drow (b, h, n, 8): per query sum ds*feat_f for the 5 rel-pos features,
    then sum ds)."""
    b, h, n, c_, nnc = _check_operands(q, k, v, pos, nc, w5, b5)
    require(g, "g", torch.float32, (b, h, n, c_))
    require(lse, "lse", torch.float32, (b, h, n, 1))
    require(delta, "delta", torch.float32, (b, h, n, 1))
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    drow = torch.empty((b, h, n, 8), dtype=torch.float32, device=q.device)
    lib = load_kernels()
    with torch.cuda.device(q.device):
        err = lib.aff_local_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), nc.data_ptr(),
            w5.data_ptr(), b5.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), drow.data_ptr(),
            b, h, n, c_, nnc, cluster_size, stream_of(q))
    check(err, "aff_local_attn_bwd")
    sfc_cluster_attention_backward.launches += 1
    return dq, dk, dv, drow


sfc_cluster_attention_backward.launches = 0


def sfc_cluster_attention_plain(q, k, v, pos, nc, w5, b5, blank_k, cluster_size: int):
    """Plain version: gather the neighbourhoods, then the unfused composition
    (padded slots get the reference's -100 instead of exact exclusion)."""
    from ..geometry.cluster import nbhd_from_cluster_ids

    n = q.shape[2]
    member, mask, rel5 = nbhd_from_cluster_ids(pos, nc, cluster_size, n)
    bias = torch.einsum("bnmf,hf->bnmh", rel5, w5) + b5
    blank_attn = torch.einsum("bhnc,hc->bhn", q, blank_k)[..., None]
    return local_cluster_attention_reference(q, k, v, member, bias, mask, blank_attn)
