"""The epsilon-scaling auction: an approximate batched assignment solver.

Counterpart of ``autofocusformermod_tpu/losses/auction.py``, step for step
(the JAX package computes it outside any Pallas kernel; this is its plain
PyTorch form, on the cost's device).  Persons (target columns, padded with
Q - T dummy persons whose benefit row is constant) bid for objects (query
rows) in parallel: each unassigned person bids its best object's price
plus the gap to its second best plus eps; each object goes to its highest
bid (ties to the lowest person), evicting its owner.  Prices carry over
six phases, eps divided by 8 after each.  With eps_final the last phase's
eps, the assignment costs at most Q * eps_final more than the optimum where
the last phase ends with everyone assigned; a person left unassigned after
``max_iters`` rounds gets a free query (greedy), so the result is always a
permutation.  The problems of a batch run in lockstep, each updated only
while it still has an unassigned person, as the JAX package's vmapped
while loop runs them.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _auction_phase(benefit, price, owner, assigned, eps, max_iters: int):
    """One eps phase over a batch: benefit (b, Q, Q) by (person, object);
    price (b, Q) float; owner (b, Q) the person owning each object (-1
    free); assigned (b, Q) the object of each person (-1 unassigned); eps
    (b,).  -> the updated (price, owner, assigned)."""
    b, T, Q = benefit.shape
    dev = benefit.device
    persons = torch.arange(T, device=dev).expand(b, T)
    objects = torch.arange(Q, device=dev).expand(b, Q)
    rows = torch.arange(b, device=dev)[:, None]
    it = 0
    while True:
        active = (assigned < 0).any(dim=1)
        if it >= max_iters or not bool(active.any()):
            break
        unassigned = assigned < 0
        value = benefit - price[:, None, :]                                   # (b, T, Q)
        best_j = value.argmax(dim=2)                                          # first maximum
        top1 = value.gather(2, best_j[..., None])[..., 0]
        top2 = value.scatter(2, best_j[..., None], float("-inf")).amax(dim=2)
        bid = price.gather(1, best_j) + (top1 - top2) + eps[:, None]
        bid = torch.where(unassigned, bid, torch.full_like(bid, _NEG))
        # each object's highest bid; among the bidders that reach it, the
        # lowest person wins
        qbid = torch.full((b, Q), _NEG, dtype=bid.dtype, device=dev).scatter_reduce(
            1, best_j, bid, "amax")
        is_win = unassigned & (qbid.gather(1, best_j) == bid)
        winner = torch.full((b, Q), T, dtype=torch.long, device=dev).scatter_reduce(
            1, best_j, torch.where(is_win, persons, torch.full_like(persons, T)), "amin")
        has_winner = (winner < T) & active[:, None]
        # the contested objects' previous owners lose them
        evicted = torch.zeros((b, T + 1), dtype=torch.bool, device=dev)
        evicted[rows, torch.where(has_winner & (owner >= 0), owner, T)] = True
        assigned = torch.where(evicted[:, :T], -1, assigned)
        owner = torch.where(has_winner, winner, owner)
        price = torch.where(has_winner, qbid, price)
        installed = torch.cat([assigned, assigned.new_full((b, 1), -1)], dim=1)
        installed[rows, torch.where(has_winner, winner, T)] = torch.where(has_winner, objects, -1)
        assigned = installed[:, :T]
        it += 1
    return price, owner, assigned


@torch.no_grad()
def auction_lsap(cost: torch.Tensor, phases: int = 6, max_iters: int = 20000) -> torch.Tensor:
    """Each target column of cost (b, Q, T), T <= Q, assigned a distinct
    query row, approximately minimising the total: -> (b, T) int64 query
    per target.  Benefits are the negated costs shifted per target (which
    leaves the assignment unchanged and keeps sentinel costs out of the eps
    range); eps starts at half their range (at least 1e-3)."""
    b, Q, T = cost.shape
    if T > Q:
        raise ValueError(f"more targets than queries: {tuple(cost.shape)}")
    benefit = -cost.detach().float().transpose(1, 2)                          # (b, T, Q)
    benefit = benefit - benefit.amax(dim=2, keepdim=True)
    benefit = torch.cat([benefit, benefit.new_zeros(b, Q - T, Q)], dim=1)     # (b, Q, Q)
    rng = torch.clamp(benefit.amax(dim=(1, 2)) - benefit.amin(dim=(1, 2)), min=1e-3)
    price = benefit.new_zeros(b, Q)
    eps = rng / 2.0
    assigned = torch.full((b, Q), -1, dtype=torch.long, device=cost.device)
    for _ in range(phases):
        assigned = torch.full((b, Q), -1, dtype=torch.long, device=cost.device)
        owner = torch.full((b, Q), -1, dtype=torch.long, device=cost.device)
        price, owner, assigned = _auction_phase(benefit, price, owner, assigned, eps, max_iters)
        eps = eps / 8.0
    # repair: a person still unassigned (the last phase ran out of rounds)
    # takes the next free query, free queries in ascending order
    rows = torch.arange(b, device=cost.device)[:, None]
    used = torch.zeros((b, Q + 1), dtype=torch.bool, device=cost.device)
    used[rows, torch.where(assigned >= 0, assigned, Q)] = True
    free_first = torch.sort(used[:, :Q].long(), dim=1, stable=True)[1]
    un_rank = torch.cumsum((assigned < 0).long(), dim=1) - 1
    assigned = torch.where(assigned < 0, free_first.gather(1, un_rank.clamp(min=0)), assigned)
    return assigned[:, :T]
