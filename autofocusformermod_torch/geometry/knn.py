"""Exact k-nearest neighbours for 2-D token positions: the ``knn`` CUDA kernel
(``csrc/knn.cu``) and its plain PyTorch version.

Counterpart of ``autofocusformermod_tpu/geometry/knn.py`` (``knn``) and of
its Pallas kernel ``ops/pallas/knn_kernel.py:knn_pallas``.  Distances are
``(qx-x)^2 + (qy-y)^2`` in fp32, ascending; ties go to the lowest database
index.  The kernel has two routes, picked from the shape (``knn_route``):
every pair ("sweep"), or the database bucketed into cells that are visited
nearest first until none can hold a closer point ("pruned").
"""

from __future__ import annotations

import contextlib

import torch

from ..ops.build import check, load_kernels
from ..ops.dispatch import require, stream_of, use_kernel

MAX_KERNEL_K = 16
# elements of one (query chunk x database) distance tile in the plain version
_TILE_BUDGET = 1 << 25
# the pruned route: about CELL_POINTS database points a cell, at most
# MAX_CELLS cells; it pays from PRUNED_MIN_DB database points
CELL_POINTS, MAX_CELLS = 16, 1024
PRUNED_MIN_DB = 512
ROUTES = ("sweep", "pruned")


def knn(query: torch.Tensor, database: torch.Tensor, k: int, return_dist: bool = False):
    """query: (b, nq, 2), database: (b, ndb, 2) -> nn_idx (b, nq, k) int32
    [, nn_dist (b, nq, k) Euclidean distances when return_dist]."""
    query = query.detach().float().contiguous()
    database = database.detach().float().contiguous()
    b, nq, d = query.shape
    ndb = database.shape[1]
    if k > ndb:
        raise ValueError(f"k={k} > n_database={ndb}")
    if use_kernel(query, database):
        idx, d2 = _knn_cuda(query, database, k)
    else:
        idx, d2 = knn_plain(query, database, k)
    if return_dist:
        return idx, torch.sqrt(d2)
    return idx


def knn_route(ndb: int) -> str:
    """The kernel for a database of ndb points: "pruned" (a cell grid over
    the database, cells visited nearest first with an early exit) from
    PRUNED_MIN_DB points on, else "sweep" (every pair)."""
    return "pruned" if ndb >= PRUNED_MIN_DB else "sweep"


def knn_cells(ndb: int) -> int:
    """The pruned route's most cells for ndb database points."""
    return max(1, min(MAX_CELLS, ndb // CELL_POINTS))


def knn_scratch_stride(ndb: int, ncap: int) -> int:
    """Bytes of the pruned route's scratch per image (csrc/knn.cu
    scratch_stride): 16 per point, 16 per cell box, 4 per cell start and
    one more int, rounded up to 16."""
    return (16 * ndb + 16 * ncap + 4 * (ncap + 1) + 15) // 16 * 16


def _knn_cuda(query: torch.Tensor, database: torch.Tensor, k: int, route: str | None = None):
    b, nq, d = query.shape
    ndb = database.shape[1]
    if d != 2 or not 1 <= k <= MAX_KERNEL_K or nq == 0 or k > ndb:
        raise ValueError(f"knn kernel takes 2-D points and 1 <= k <= min({MAX_KERNEL_K}, ndb), "
                         f"nq > 0 (got d={d}, k={k}, nq={nq}, ndb={ndb})")
    route = route or knn_route(ndb)
    if route not in ROUTES:
        raise ValueError(f"knn route {route!r} is not one of {ROUTES}")
    require(query, "query", torch.float32, (b, nq, 2))
    require(database, "database", torch.float32, (b, ndb, 2))
    dev = query.device
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, nq, k), dtype=torch.float32, device=dev)
    lib = load_kernels()
    # the device guard costs host time on every call: entered only when the
    # operands are not on the current device
    same = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        if route == "sweep":
            err = lib.aff_knn(query.data_ptr(), database.data_ptr(), idx.data_ptr(),
                              d2.data_ptr(), b, nq, ndb, k, stream_of(query))
        else:
            ncap = knn_cells(ndb)
            stride = knn_scratch_stride(ndb, ncap)
            scratch = torch.empty(b * stride, dtype=torch.uint8, device=dev)
            err = lib.aff_knn_pruned(query.data_ptr(), database.data_ptr(), idx.data_ptr(),
                                     d2.data_ptr(), scratch.data_ptr(), stride, b, nq, ndb, k,
                                     ncap, stream_of(query))
    check(err, "aff_knn" if route == "sweep" else "aff_knn_pruned")
    knn.launches += 1
    knn.launches_by_route[route] += 1
    return idx, d2


knn.launches = 0
knn.launches_by_route = {r: 0 for r in ROUTES}


def knn_plain(query: torch.Tensor, database: torch.Tensor, k: int):
    """Plain version: the brute-force sweep of the JAX package, in query
    chunks; k rounds of argmin (first index on ties) with the winner masked.
    Returns (idx (b, nq, k) int32, d2 (b, nq, k) f32)."""
    b, nq, _ = query.shape
    ndb = database.shape[1]
    chunk = max(1, min(nq, _TILE_BUDGET // max(ndb, 1)))
    idxs, dists = [], []
    for s in range(0, nq, chunk):
        diff = query[:, s:s + chunk, None, :] - database[:, None, :, :]
        d2 = (diff * diff).sum(-1)                                   # (b, c, ndb)
        ci, cd = [], []
        for _ in range(k):
            i = torch.argmin(d2, dim=-1, keepdim=True)
            ci.append(i)
            cd.append(torch.gather(d2, -1, i))
            d2.scatter_(-1, i, float("inf"))
        idxs.append(torch.cat(ci, -1))
        dists.append(torch.cat(cd, -1))
    return torch.cat(idxs, 1).int(), torch.cat(dists, 1)
