"""Local cluster attention over SFC-ordered tokens: the ``local_attn`` CUDA
kernels (``csrc/local_attn.cu``, forward and backward) and their plain
PyTorch version.

Counterpart of ``autofocusformermod_tpu/ops/pallas/local_attn.py``
(``sfc_cluster_attention`` and its custom VJP ``_sfc_attention_backward``).
On CUDA tensors the call is an autograd Function: the forward kernel also
emits the row log-sum-exp, and the backward recomputes the probabilities
from it.  The backward is a pair of kernels, as on the TPU: the query side
writes dq and stores p and ds, the key side sums dk and dv per key cluster
over that cluster's *reverse list* (``build_reverse_lists``: which (query,
slot group) pairs refer to it, in a fixed order), so it needs no atomics and
the same inputs give the same bits.  The lists depend on ``nc`` alone: a
caller that runs many layers over one ``nc`` builds them once and passes
them as ``reverse=``.  The plain version's gradient is PyTorch's autograd
through the gather composition; ``sfc_cluster_attention_backward_plain`` is
the kernel pair's own arithmetic in plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .build import check, load_kernels
from .dispatch import local_cluster_attention_reference, require, stream_of, use_kernel


class ReverseLists(NamedTuple):
    """Per image, the references to each key cluster, as a CSR: the
    references of cluster c are ``refs[offsets[c]:offsets[c + 1]]``, each
    ``i * nnc + t`` for "slot group t of query i is cluster c", ascending."""

    offsets: torch.Tensor    # (b, n_clusters + 1) int32
    refs: torch.Tensor       # (b, n * nnc) int32; past offsets[-1]: the left-out ones


def build_reverse_lists(nc: torch.Tensor, n: int, cluster_size: int) -> ReverseLists:
    """The reverse of ``nc`` (b, nq, nnc): for every key cluster of an n-token
    image, who refers to it.  A stable sort of the flattened ids, so the
    references of a cluster are ordered by query and then by slot group.  An
    id that is negative or whose cluster starts at or beyond n refers to no
    token and is left out; a cluster that one query lists twice gets two
    references."""
    b = nc.shape[0]
    n_clusters = -(-n // cluster_size)
    ids = nc.reshape(b, -1).long()
    # the left-out ids sort behind the last cluster
    ids = torch.where((ids >= 0) & (ids * cluster_size < n), ids, n_clusters)
    refs = torch.sort(ids, dim=1, stable=True).indices.int()
    counts = torch.zeros((b, n_clusters + 1), dtype=torch.int64, device=nc.device)
    counts.scatter_add_(1, ids, torch.ones_like(ids))
    offsets = torch.zeros((b, n_clusters + 1), dtype=torch.int32, device=nc.device)
    offsets[:, 1:] = counts[:, :-1].cumsum(1)
    return ReverseLists(offsets, refs)


def sfc_cluster_attention(q, k, v, pos, nc, w5, b5, blank_k, cluster_size: int,
                          reverse: Optional[ReverseLists] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local attention of token i over the tokens of its neighbour clusters.

    q/k/v: (b, h, n, c_) f32 (q pre-scaled); pos: (b, n, 2) f32; nc: (b, n,
    nnc) int32 neighbour cluster ids (cluster c = tokens [c*cluster_size,
    (c+1)*cluster_size)); w5: (h, 5), b5: (h,) the rel-pos bias Linear;
    blank_k: (h, c_).  Returns (out (b, h, n, c_), blank_prob (b, h, n, 1)),
    differentiable in q, k, v, w5, b5 and blank_k (not in pos or nc).
    ``reverse``: ``build_reverse_lists(nc, n, cluster_size)`` where the caller
    has it already (the backward kernels need it; built there if None).
    """
    if not use_kernel(q, k, v, pos, nc, w5, b5, blank_k):
        return sfc_cluster_attention_plain(q, k, v, pos, nc, w5, b5, blank_k, cluster_size)
    return _LocalAttention.apply(q, k, v, pos, nc, w5, b5, blank_k, cluster_size, reverse)


class _LocalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pos, nc, w5, b5, blank_k, cluster_size, reverse=None):
        out, blank, lse = local_attn_forward(q, k, v, pos, nc, w5, b5, blank_k, cluster_size)
        ctx.save_for_backward(q, k, v, pos, nc, w5, b5, blank_k, out, blank, lse)
        ctx.cluster_size = cluster_size
        ctx.reverse = reverse           # index tensors, no gradient
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
            q, k, v, pos, nc, w5, b5, g, lse, delta.contiguous(), ctx.cluster_size,
            ctx.reverse)
        dq = dq + dsb * blank_k[None, :, None, :]
        dblank_k = torch.einsum("bhn,bhnc->hc", dsb[..., 0], q)
        dw5 = drow[..., :5].sum((0, 2))
        db5 = drow[..., 5].sum((0, 2))
        return dq, dk, dv, None, None, dw5, db5, dblank_k, None, None


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
                                   cluster_size: int,
                                   reverse: Optional[ReverseLists] = None):
    """Launch the backward kernel pair -> (dq without the blank term, dk, dv,
    drow (b, h, n, 8): per query sum ds*feat_f for the 5 rel-pos features,
    then sum ds).  One launch is counted per call, both kernels together.
    Every element of the results is written by a plain store: nothing is
    zero-filled, and two calls on the same inputs return the same bits."""
    if not use_kernel(q, k, v, pos, nc, w5, b5, g, lse, delta):
        return sfc_cluster_attention_backward_plain(q, k, v, pos, nc, w5, b5, g, lse, delta,
                                                    cluster_size, reverse)
    if reverse is None:
        reverse = build_reverse_lists(nc, q.shape[2], cluster_size)
    dq, drow, p, ds = backward_query_side(q, k, v, pos, nc, w5, b5, g, lse, delta, cluster_size)
    dk, dv = backward_key_side(q, g, p, ds, reverse, nc.shape[-1], cluster_size)
    sfc_cluster_attention_backward.launches += 1
    return dq, dk, dv, drow          # p and ds are freed here


sfc_cluster_attention_backward.launches = 0


def backward_query_side(q, k, v, pos, nc, w5, b5, g, lse, delta, cluster_size: int):
    """Launch the query-side kernel -> (dq without the blank term, drow, and
    p, ds (b, h, n, nnc * cluster_size): the probability and the logit
    gradient of every (query, slot), zero at an invalid slot)."""
    b, h, n, c_, nnc = _check_operands(q, k, v, pos, nc, w5, b5)
    require(g, "g", torch.float32, (b, h, n, c_))
    require(lse, "lse", torch.float32, (b, h, n, 1))
    require(delta, "delta", torch.float32, (b, h, n, 1))
    dq = torch.empty_like(q)
    drow = torch.empty((b, h, n, 8), dtype=torch.float32, device=q.device)
    p = torch.empty((b, h, n, nnc * cluster_size), dtype=torch.float32, device=q.device)
    ds = torch.empty_like(p)
    lib = load_kernels()
    with torch.cuda.device(q.device):
        err = lib.aff_local_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), nc.data_ptr(),
            w5.data_ptr(), b5.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), drow.data_ptr(), p.data_ptr(), ds.data_ptr(),
            b, h, n, c_, nnc, cluster_size, stream_of(q))
    check(err, "aff_local_attn_bwd_dq")
    return dq, drow, p, ds


def backward_key_side(q, g, p, ds, reverse: ReverseLists, nnc: int, cluster_size: int):
    """Launch the key-side kernel on the query side's p and ds -> (dk, dv)."""
    b, h, n, c_ = q.shape
    n_clusters = -(-n // cluster_size)
    require(q, "q", torch.float32, (b, h, n, c_))
    require(g, "g", torch.float32, (b, h, n, c_))
    require(p, "p", torch.float32, (b, h, n, nnc * cluster_size), align=16)
    require(ds, "ds", torch.float32, (b, h, n, nnc * cluster_size), align=16)
    require(reverse.offsets, "reverse.offsets", torch.int32, (b, n_clusters + 1))
    require(reverse.refs, "reverse.refs", torch.int32, (b, n * nnc))
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    lib = load_kernels()
    with torch.cuda.device(q.device):
        err = lib.aff_local_attn_bwd_dkv(
            q.data_ptr(), g.data_ptr(), p.data_ptr(), ds.data_ptr(),
            reverse.offsets.data_ptr(), reverse.refs.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n, c_, nnc, cluster_size, stream_of(q))
    check(err, "aff_local_attn_bwd_dkv")
    return dk, dv


def attention_scores(q, k, pos, nc, w5, b5, cluster_size: int):
    """The logits the kernels see -> (member (b, n, m) token index of every
    slot, valid (b, 1, n, m) bool, s (b, h, n, m) = q.k + rel-pos bias,
    rel5 (b, n, m, 5)); an invalid slot is excluded exactly, not by -100."""
    from ..geometry.cluster import nbhd_from_cluster_ids
    from .clusten import cluster_qk

    member, mask, rel5 = nbhd_from_cluster_ids(pos, nc, cluster_size, q.shape[2])
    valid = torch.ones_like(member, dtype=torch.bool) if mask is None else mask > 0
    s = cluster_qk(q, k, member) + torch.einsum("bnmf,hf->bhnm", rel5, w5) + b5[:, None, None]
    return member, valid[:, None], s, rel5


def local_attn_forward_plain(q, k, v, pos, nc, w5, b5, blank_k, cluster_size: int):
    """Plain version of ``local_attn_forward``: the plain attention's out and
    blank_prob, and the row log-sum-exp over the valid slots and the blank
    sink that the backward recomputes the probabilities from."""
    _, valid, s, _ = attention_scores(q, k, pos, nc, w5, b5, cluster_size)
    blank_logit = torch.einsum("bhnc,hc->bhn", q, blank_k)[..., None]
    s = torch.where(valid, s, torch.full_like(s, -torch.inf))
    lse = torch.logsumexp(torch.cat([s, blank_logit], -1), -1, keepdim=True)
    out, blank = sfc_cluster_attention_plain(q, k, v, pos, nc, w5, b5, blank_k, cluster_size)
    return out, blank, lse


def sfc_cluster_attention_backward_plain(q, k, v, pos, nc, w5, b5, g, lse, delta,
                                         cluster_size: int,
                                         reverse: Optional[ReverseLists] = None):
    """Plain version of the backward kernel pair, with its structure: first
    p = exp(s - lse) and ds = p (g.v - delta) per (query, slot), dq and drow
    from them (the query side); then dk and dv summed per key cluster through
    the reverse lists (the key side)."""
    from .clusten import cluster_av, cluster_qk

    b, h, n, c_ = q.shape
    nnc, span = nc.shape[-1], cluster_size
    member, valid, s, rel5 = attention_scores(q, k, pos, nc, w5, b5, span)
    p = torch.where(valid, torch.exp(s - lse), torch.zeros_like(s))
    ds = p * (cluster_qk(g, v, member) - delta)
    dq = cluster_av(ds, k, member)
    drow = torch.cat([torch.einsum("bhnm,bnmf->bhnf", ds, rel5), ds.sum(-1, keepdim=True),
                      torch.zeros_like(ds[..., :2])], -1)

    if reverse is None:
        reverse = build_reverse_lists(nc, n, span)
    offsets, refs = reverse.offsets.long(), reverse.refs.long()
    n_refs = refs.shape[1]
    at = torch.arange(n_refs, device=q.device).expand(b, n_refs).contiguous()
    live = at < offsets[:, -1:]                       # the left-out ones lie behind
    # the cluster a list position belongs to: how many lists end at or before it
    cluster = torch.searchsorted(offsets[:, 1:].contiguous(), at, right=True)
    query, group = refs // nnc, refs % nnc
    rows = cluster[..., None] * span + torch.arange(span, device=q.device)     # (b, r, span)
    live = live[..., None] & (rows < n)
    rows = torch.where(live, rows, torch.zeros_like(rows)).reshape(b, 1, -1, 1)

    def key_side(weight, src):
        """sum over references of weight[query, group's slots] * src[query]."""
        w = weight.reshape(b, h, n, nnc, span)
        w = w[torch.arange(b, device=q.device)[:, None], :, query, group]       # (b, r, h, span)
        w = w.permute(0, 2, 1, 3) * live[:, None]                               # (b, h, r, span)
        rows_src = torch.gather(src, 2, query[:, None, :, None].expand(b, h, n_refs, c_))
        contrib = (w[..., None] * rows_src[:, :, :, None, :]).reshape(b, h, -1, c_)
        return torch.zeros_like(src).scatter_add_(2, rows.expand(b, h, -1, c_), contrib)

    return dq, key_side(ds, q), key_side(p, g), drow


def sfc_cluster_attention_plain(q, k, v, pos, nc, w5, b5, blank_k, cluster_size: int):
    """Plain version: gather the neighbourhoods, then the unfused composition
    (padded slots excluded exactly, as the kernels exclude them)."""
    from ..geometry.cluster import nbhd_from_cluster_ids

    n = q.shape[2]
    member, mask, rel5 = nbhd_from_cluster_ids(pos, nc, cluster_size, n)
    bias = torch.einsum("bnmf,hf->bnmh", rel5, w5) + b5
    blank_attn = torch.einsum("bhnc,hc->bhn", q, blank_k)[..., None]
    return local_cluster_attention_reference(q, k, v, member, bias, mask, blank_attn)
