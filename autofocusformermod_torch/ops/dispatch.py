"""The device rule every kernel wrapper follows, and the unfused local
attention (the semantic definition of the ``local_attn`` kernel).

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
kernel's plain PyTorch version.  There is no silent fallback: a CUDA call
launches its kernel or raises.  ``plain_versions()`` is the one explicit way
to run the plain versions on CUDA tensors, used to hold the kernels against
them on the card.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from .clusten import cluster_av, cluster_qk

_PLAIN_ON_CUDA = contextvars.ContextVar("plain_on_cuda", default=False)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version).  Mixed devices and other device types raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"kernel operands on different devices: {dev} vs {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return not _PLAIN_ON_CUDA.get()
    raise ValueError(f"no kernel and no plain version for device {dev}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...],
            align: int = 1) -> None:
    """Raise unless a kernel operand has this dtype and shape, is contiguous
    and starts at a multiple of ``align`` bytes (for kernels that read it in
    vectors; a view into a larger tensor may not)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel operands must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: the kernel reads {align} bytes at a time and needs the tensor "
                         f"to start at a multiple of that; pass a copy (.clone())")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream on t's device, as the handle a C launcher takes."""
    return torch.cuda.current_stream(t.device).cuda_stream


@contextlib.contextmanager
def plain_versions():
    """Within this block, CUDA tensors also run the plain PyTorch versions."""
    token = _PLAIN_ON_CUDA.set(True)
    try:
        yield
    finally:
        _PLAIN_ON_CUDA.reset(token)


def local_cluster_attention_reference(
    q: torch.Tensor,
    key: torch.Tensor,
    v: torch.Tensor,
    member_idx: torch.Tensor,
    pos_bias: torch.Tensor,
    cluster_mask: Optional[torch.Tensor],
    blank_attn: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unfused gather composition.

    q/key/v: (b, h, n, c_); member_idx: (b, n, m); pos_bias: (b, n, m, h);
    cluster_mask: (b, n, m) or None (padded slots get -100); blank_attn:
    (b, h, n, 1) pre-softmax logit.  Returns (feat (b, h, n, c_),
    blank_prob (b, h, n, 1)).
    """
    b, h, n, _ = q.shape
    attn = cluster_qk(q, key, member_idx) + pos_bias.permute(0, 3, 1, 2)
    if cluster_mask is not None:
        attn = attn + (1 - cluster_mask.reshape(b, 1, n, -1)) * (-100.0)
    attn = torch.softmax(torch.cat([attn, blank_attn], dim=-1), dim=-1)
    return cluster_av(attn[..., :-1], v, member_idx), attn[..., -1:]
