"""Shepard (inverse-distance) interpolation over point clouds.

Counterpart of ``autofocusformermod_tpu/geometry/shepard.py``.  As in the
reference, *squared* distances go into the weight function and the
configured power is halved by the caller.
"""

from __future__ import annotations

import torch

from ..ops.clusten import weighted_gather
from ..ops.gather import take_rows
from .knn import knn


def shepard_decay_weights(dist: torch.Tensor, power=3.0) -> torch.Tensor:
    """Normalized inverse-distance weights (clamp 1e-2, eps 1e-6); dist: (b, n, k)."""
    dist = torch.clamp(dist, min=1e-2)
    if not isinstance(power, torch.Tensor) and float(power).is_integer():
        power = int(power)
    ipd = 1.0 / (dist ** power + 1e-6)
    return ipd / (ipd.sum(dim=2, keepdim=True) + 1e-6)


def shepard_neighbours(query: torch.Tensor, database: torch.Tensor, k: int = 4, power=3.0):
    """The k nearest database points (b, n_, 2) of each query (b, n, 2) and
    their normalized Shepard weights -> (nn_idx (b, n, k) int32, weights
    (b, n, k)): what ``upsample_feature_shepard`` needs besides the feature,
    so that several features upsampled between the same two point sets share
    one ``knn``."""
    k = min(k, database.shape[1])
    nn_idx = knn(query, database, k)
    nn_pos = take_rows(database, nn_idx)                                  # (b, n, k, 2)
    nn_dist = ((query[:, :, None, :] - nn_pos) ** 2).sum(-1)              # squared
    return nn_idx, shepard_decay_weights(nn_dist, power)


def upsample_feature_shepard(query: torch.Tensor, database: torch.Tensor,
                             feature: torch.Tensor, k: int = 4, power=3.0) -> torch.Tensor:
    """Interpolate ``feature`` (b, n_, c), given at ``database`` (b, n_, 2),
    at ``query`` (b, n, 2) from its k nearest database points -> (b, n, c)."""
    return weighted_gather(*shepard_neighbours(query, database, k, power), feature)
