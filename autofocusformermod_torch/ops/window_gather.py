"""Row lookup in a channel-major table: the ``window_gather`` CUDA kernel
(``csrc/window_gather.cu``) and its plain PyTorch version.

Counterpart of ``autofocusformermod_tpu/ops/pallas/window_gather.py``
(``windowed_row_gather``).  The TPU kernel's band window (``k_sub``,
``tile_s``) is how it gathers along lanes; the card reads any address, so the
port's function takes the table and the indices only.  It copies floats: the
result equals the plain version exactly.  No gradient (the tables are
geometry, not parameters).

The kernel has two routes, chosen from the shapes alone
(``window_gather_route``): ``"shared"`` stages one (image, channel) slice of
the table in the SM's shared memory and looks the samples up there;
``"direct"`` reads the table where it lies, for a slice that does not fit or
a call with fewer samples than rows.  ``windowed_row_gather.launches`` counts
both, ``windowed_row_gather.launches_by_route`` each.
"""

from __future__ import annotations

import torch

from .build import check, load_kernels
from .dispatch import require, stream_of, use_kernel

MAX_CHANNELS = 32
# the largest (image, channel) slice the shared route stages: 224 KB of the
# 227 KB of shared memory a block may use on the H100 (csrc/window_gather.cu)
SHARED_SLICE_ROWS = 57344


def window_gather_route(n: int, s: int) -> str:
    """The kernel route for an N-row table and S samples per image: a pure
    function of the shapes.  "shared" where a slice of N floats fits shared
    memory and there are at least as many samples as rows (staging the slice
    reads every row once; with fewer samples reading in place moves less),
    else "direct"."""
    return "shared" if n <= SHARED_SLICE_ROWS and s >= n else "direct"


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
    out = table_cm.new_empty((b, c, s))
    lib = load_kernels()
    route = window_gather_route(n, s)
    name = "aff_window_gather_shared" if route == "shared" else "aff_window_gather"
    with torch.cuda.device(table_cm.device):
        err = getattr(lib, name)(table_cm.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                 b, c, n, s, stream_of(table_cm))
    check(err, name)
    windowed_row_gather.launches += 1
    windowed_row_gather.launches_by_route[route] += 1
    return out


windowed_row_gather.launches = 0
windowed_row_gather.launches_by_route = {"shared": 0, "direct": 0}


def windowed_row_gather_plain(table_cm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: one gather along the last axis, the index shared by the channels."""
    b, c, _ = table_cm.shape
    return torch.gather(table_cm.detach(), 2, idx.long()[:, None, :].expand(b, c, idx.shape[1]))
