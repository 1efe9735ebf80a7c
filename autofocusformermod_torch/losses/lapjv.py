"""Exact linear sum assignment (Jonker-Volgenant shortest augmenting paths
with potentials): the ``lapjv`` CUDA kernel (``csrc/lapjv.cu``: one warp per
problem with its costs in shared memory, or one thread block per problem
for shapes the warp cannot hold; ``lapjv_route``) and its plain PyTorch
version.

Counterpart of ``autofocusformermod_tpu/losses/lapjv.py`` (``hungarian_lsap``)
and of its Pallas kernel ``ops/pallas/lapjv_kernel.py:lsap_pallas``.  For
each of the T targets (rows) one Dijkstra over the Q >= T queries (columns)
grows an alternating tree until it reaches a free column, then augments.
Costs are clamped to +-3e4 so that the matcher's 1e8 sentinel for padded
targets cannot swamp the fp32 duals; ties go to the first index.  A NaN cost
counts as the largest cost (+3e4) and +-inf are clamped like any other value,
in the kernel and in the plain version alike, so both terminate on any input
and return a valid assignment (distinct queries).
"""

from __future__ import annotations

import torch

from ..ops.build import check, load_kernels
from ..ops.dispatch import require, stream_of

COST_CLIP = 3e4


# the warp route: a lane holds ceil((Q + 1) / 32) columns, at most this many,
# and the (Q, T | 1) costs must fit the card's shared memory per block
WARP_MAX_SLOTS = 8
SMEM_BYTES = 232448
ROUTES = ("warp", "block")


def lapjv_route(q: int, t: int) -> str:
    """The kernel that solves (Q, T) problems: "warp" (one warp per problem,
    its costs in shared memory) where Q + 1 <= 32 * WARP_MAX_SLOTS and the
    costs fit; else "block" (a thread block per problem, state in shared
    memory)."""
    if q + 1 <= 32 * WARP_MAX_SLOTS and q * (t | 1) * 4 <= SMEM_BYTES:
        return "warp"
    return "block"


def lapjv(cost: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """Launch the kernel: cost (b, Q, T) f32 on the card, T <= Q -> (b, T)
    int64 matched query per target (the same as ``hungarian_lsap``), on the
    route ``lapjv_route`` picks (or the one named).  The kernel reads the
    (b, Q, T) layout in place.  On a cost matrix that holds NaN or +-inf it
    still returns distinct queries: the optimum of the matrix with NaN read
    as +3e4 and the rest clamped to +-3e4.  Whether such a matching means
    anything is the caller's concern."""
    b, q, t = cost.shape
    route = route or lapjv_route(q, t)
    if route not in ROUTES:
        raise ValueError(f"lapjv route {route!r} is not one of {ROUTES}")
    require(cost, "cost", torch.float32, (b, q, t))
    out = torch.empty((b, t), dtype=torch.int32, device=cost.device)
    lib = load_kernels()
    with torch.cuda.device(cost.device):
        err = lib.aff_lapjv(cost.data_ptr(), out.data_ptr(), b, q, t, ROUTES.index(route),
                            stream_of(cost))
    check(err, "aff_lapjv")
    lapjv.launches += 1
    lapjv.launches_by_route[route] += 1
    return out.long()


lapjv.launches = 0
lapjv.launches_by_route = {r: 0 for r in ROUTES}


def hungarian_lsap(cost: torch.Tensor, return_steps: bool = False):
    """Plain version: all b problems in lockstep, each Dijkstra step one set
    of (b, Q+1) tensor ops; a finished problem is masked until the slowest
    one augments.  The float operations are the kernel's, in its order.
    With ``return_steps`` it also returns steps (b, T) int64: the Dijkstra
    steps (columns added to the tree) each problem took for each row, the
    chain of dependent steps that the kernel runs in series."""
    b, q, t = cost.shape
    dev = cost.device
    c = torch.clamp(torch.nan_to_num(cost.transpose(1, 2).float(), nan=COST_CLIP),
                    -COST_CLIP, COST_CLIP)
    c = torch.nn.functional.pad(c, (1, 0, 1, 0))                    # (b, T+1, Q+1)
    inf = torch.tensor(float("inf"), device=dev)
    ar = torch.arange(b, device=dev)
    cols = torch.arange(q + 1, device=dev)
    rows = torch.arange(t + 1, device=dev)
    u = torch.zeros((b, t + 1), device=dev)
    v = torch.zeros((b, q + 1), device=dev)
    p = torch.zeros((b, q + 1), dtype=torch.long, device=dev)        # row of column j
    steps = torch.zeros((b, t), dtype=torch.long, device=dev)
    for r in range(1, t + 1):
        minv = torch.full((b, q + 1), float("inf"), device=dev)
        way = torch.zeros((b, q + 1), dtype=torch.long, device=dev)
        used = cols[None] == 0
        used = used.expand(b, q + 1).clone()
        rows_in = (rows == r)[None].expand(b, t + 1).clone()          # the tree's rows
        p[:, 0] = r
        j0 = torch.zeros(b, dtype=torch.long, device=dev)
        active = torch.ones(b, dtype=torch.bool, device=dev)
        while True:
            steps[:, r - 1] += active
            i0 = p[ar, j0]
            cur = c[ar, i0] - u[ar, i0][:, None] - v
            a = active[:, None]
            better = (cur < minv) & ~used & a
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0[:, None], way)
            mm = torch.where(used, inf, minv)
            delta = mm.min(dim=1, keepdim=True).values
            # the first index of the minimum, spelled out rather than left to
            # torch.argmin's tie rule (the sentinel columns tie exactly)
            j1 = torch.where(mm == delta, cols[None], q + 1).min(dim=1).values
            u = torch.where(rows_in & a, u + delta, u)
            v = torch.where(used & a, v - delta, v)
            minv = torch.where(~used & a, minv - delta, minv)
            used = used | ((cols[None] == j1[:, None]) & a)
            pj1 = p[ar, j1]
            rows_in = rows_in | ((rows[None] == pj1[:, None]) & a)
            j0 = torch.where(active, j1, j0)
            active = active & (pj1 > 0)
            if not bool(active.any()):
                break
        live = j0 > 0
        while bool(live.any()):                    # augment along the path
            j1 = way[ar, j0]
            p[ar, j0] = torch.where(live, p[ar, j1], p[ar, j0])
            j0 = torch.where(live, j1, j0)
            live = j0 > 0
    # invert: the one column holding each row, by compare-and-sum (a
    # scatter_ over p, where every free column writes slot 0, gave other
    # results on CUDA than on the CPU)
    hit = p[:, None, :] == rows[1:, None]                              # (b, T, Q+1)
    assignment = torch.where(hit, cols, 0).sum(-1) - 1
    return (assignment, steps) if return_steps else assignment
