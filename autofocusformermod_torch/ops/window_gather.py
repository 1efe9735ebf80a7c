"""Row lookup in a channel-major table: the ``window_gather`` CUDA kernel
(``csrc/window_gather.cu``) and its plain PyTorch version.

Counterpart of ``autofocusformermod_tpu/ops/pallas/window_gather.py``
(``windowed_row_gather``).  The TPU kernel's band window (``k_sub``,
``tile_s``) is how it gathers along lanes; the card reads any address, so the
port's function takes the table and the indices only.  It copies floats: the
result equals the plain version exactly.  No gradient (the tables are
geometry, not parameters).
"""

from __future__ import annotations

import torch

from .build import check, load_kernels
from .dispatch import require, stream_of, use_kernel

MAX_CHANNELS = 32


def windowed_row_gather_supported(table_cm: torch.Tensor, idx: torch.Tensor) -> bool:
    return table_cm.dim() == 3 and table_cm.shape[1] <= MAX_CHANNELS and idx.dim() == 2


def windowed_row_gather(table_cm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, :, s] = table_cm[b, :, idx[b, s]].

    table_cm: (b, C, N) f32 channel-major, C <= 32; idx: (b, S) int32 row ids
    in [0, N).  Returns (b, C, S), detached from the table's graph.
    """
    if not windowed_row_gather_supported(table_cm, idx):
        raise ValueError(f"windowed_row_gather takes a (b, C <= {MAX_CHANNELS}, N) table and (b, S) "
                         f"indices, got {tuple(table_cm.shape)} and {tuple(idx.shape)}")
    if not use_kernel(table_cm, idx):
        return windowed_row_gather_plain(table_cm, idx)
    table_cm = table_cm.detach()
    b, c, n = table_cm.shape
    s = idx.shape[1]
    require(table_cm, "table_cm", torch.float32, (b, c, n))
    require(idx, "idx", torch.int32, (b, s))
    out = torch.empty((b, c, s), dtype=torch.float32, device=table_cm.device)
    lib = load_kernels()
    with torch.cuda.device(table_cm.device):
        err = lib.aff_window_gather(table_cm.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                    b, c, n, s, stream_of(table_cm))
    check(err, "aff_window_gather")
    windowed_row_gather.launches += 1
    return out


windowed_row_gather.launches = 0


def windowed_row_gather_plain(table_cm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: one gather along the last axis, the index shared by the channels."""
    b, c, _ = table_cm.shape
    return torch.gather(table_cm.detach(), 2, idx.long()[:, None, :].expand(b, c, idx.shape[1]))
