"""The ground-truth-edge oracle of the OracleTeacher cascades.

Counterpart of ``autofocusformermod_tpu/models/oracle.py``:

- ``gt_edge_map``: the boundary pixels of a semantic map;
- ``oracle_upsampling_mask``: per token, the share of edge pixels inside its
  image patch, normalised by the image's largest share -- the score the
  backbone's upsampling heads are trained to predict;
- ``mix_teacher_mask``: per image, the oracle replaces the predicted score
  with probability ``teacher_ratio`` (training only);
- ``upsampling_mse_loss``: the mean over stages of the squared error of the
  predicted scores against the oracle.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..parallel import mesh


def gt_edge_map(sem_seg: torch.Tensor, ignore_label: int = 255) -> torch.Tensor:
    """(b, H, W) integer labels -> (b, H, W) float 0/1: a pixel is an edge
    where its label differs from the one below it or the one to its right
    and neither is ``ignore_label``."""
    v = sem_seg != ignore_label
    e = torch.zeros(sem_seg.shape, dtype=torch.bool, device=sem_seg.device)
    e[:, :-1] = (sem_seg[:, :-1] != sem_seg[:, 1:]) & v[:, :-1] & v[:, 1:]
    e[:, :, :-1] |= (sem_seg[:, :, :-1] != sem_seg[:, :, 1:]) & v[:, :, :-1] & v[:, :, 1:]
    return e.float()


def oracle_upsampling_mask(edges: torch.Tensor, pos_xy: torch.Tensor, scale: torch.Tensor,
                           patch_sizes: Sequence[int], min_patch_size: int) -> torch.Tensor:
    """Per token, the share of edge pixels in its patch, divided by the
    image's largest share (at least 1e-6).  edges: (b, H, W); pos_xy: (b, n,
    2) on the min-patch canvas; scale: (b, n), which picks the patch size
    from ``patch_sizes`` (clipped into the table).  Patches are clipped to
    the image; box sums come from an integral image.  -> (b, n)."""
    b, H, W = edges.shape
    ii = torch.nn.functional.pad(edges.cumsum(1).cumsum(2), (1, 0, 1, 0)).reshape(b, -1)
    x0 = (pos_xy[..., 0] * min_patch_size).long()
    y0 = (pos_xy[..., 1] * min_patch_size).long()
    table = torch.tensor(list(patch_sizes), dtype=torch.long, device=edges.device)
    ps = table[torch.clamp(scale.long(), 0, len(patch_sizes) - 1)]
    x1, y1 = torch.clamp(x0 + ps, 0, W), torch.clamp(y0 + ps, 0, H)
    x0, y0 = torch.clamp(x0, 0, W), torch.clamp(y0, 0, H)

    def at(y, x):
        return torch.gather(ii, 1, y * (W + 1) + x)

    box = at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)
    frac = box / torch.clamp((x1 - x0) * (y1 - y0), min=1).float()
    return frac / torch.clamp(frac.amax(dim=1, keepdim=True), min=1e-6)


def mix_teacher_mask(generator: Optional[torch.Generator], predicted: torch.Tensor,
                     oracle: torch.Tensor, teacher_ratio: float,
                     use_oracle: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each image's row of ``predicted`` (b, n) replaced by the oracle's with
    probability ``teacher_ratio``: one uniform draw per image from
    ``generator`` (on the tensors' device), or the (b, 1) bool ``use_oracle``
    where the caller gives it.  ``predicted`` unchanged when the ratio is
    at most 0."""
    if teacher_ratio <= 0:
        return predicted
    if use_oracle is None:
        use_oracle = mesh.global_rand((predicted.shape[0], 1), generator,
                                      predicted.device) < teacher_ratio
    return torch.where(use_oracle, oracle, predicted)


def upsampling_mse_loss(predicted_masks: Sequence[torch.Tensor],
                        oracle_masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean over stages of each stage's mean squared error of the
    predicted scores against the oracle (no gradient to the oracle); 0 when
    there is no stage."""
    losses = [((p - o.detach()) ** 2).mean() for p, o in zip(predicted_masks, oracle_masks)]
    return torch.stack(losses).mean() if losses else torch.zeros(())
