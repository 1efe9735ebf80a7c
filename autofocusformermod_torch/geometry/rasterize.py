"""Point-cloud -> grid rasterization.

Counterpart of ``autofocusformermod_tpu/geometry/rasterize.py``'s
``point2img``: scatter per-token values onto an h x w canvas by their
integer positions; blank cells are zero.  The JAX function asserts that the
tokens cover the canvas; this one also takes fewer (the plain decoder over
an MRML backbone), as the upstream scatter does.  Where the tokens cover the
canvas in raster order (every call site of the MaskFiner decoder) the
scatter is a reshape.
"""

from __future__ import annotations

import torch


def point2img(x: torch.Tensor, pos: torch.Tensor, mask_size) -> torch.Tensor:
    """Per-query mask logits onto the canvas: x (b, q, n), pos (b, n, 2) at
    distinct cells of the (h, w) ``mask_size`` canvas -> (b, q, h, w), cells
    no token covers 0."""
    b, q, n = x.shape
    h, w = int(mask_size[0]), int(mask_size[1])
    if n > h * w:
        raise ValueError(f"point2img: {n} tokens on a {h}x{w} canvas")
    ret = x.new_zeros((b, q, h * w))
    cells = pos[..., 1].long() * w + pos[..., 0].long()          # truncated (x, y)
    ret.scatter_(2, cells[:, None, :].expand(b, q, n), x)
    return ret.reshape(b, q, h, w)
