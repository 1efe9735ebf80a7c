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
from typing import Callable, Optional, Tuple

import torch

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
    drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unfused gather composition.

    q/key/v: (b, h, n, c_); member_idx: (b, n, m); pos_bias: (b, n, m, h);
    cluster_mask: (b, n, m) or None; blank_attn: (b, h, n, 1) pre-softmax
    logit; ``drop``: applied to the probabilities (b, h, n, m + 1), the
    blank sink's column with them, before they are split (the JAX gather
    path's attention dropout).  Returns (feat (b, h, n, c_), blank_prob (b,
    h, n, 1)).

    Padded slots (mask 0: past the last token of a cut last cluster) are
    excluded exactly, as the kernels and the JAX package's semantic
    definition (``sfc_attention_reference``, the mask formulation, and its
    TPU kernel) exclude them.  The JAX gather composition adds -100 to them
    instead, with token 0 standing in; where that token lies far from the
    query its rel-pos bias can pass 100 (at random initialisation on
    AFF-Mini-1/5's 655- and 131-token stages), and the slot keeps weight.
    """
    from .clusten import cluster_av, cluster_qk     # clusten imports this module

    b, h, n, _ = q.shape
    attn = cluster_qk(q, key, member_idx) + pos_bias.permute(0, 3, 1, 2)
    if cluster_mask is not None:
        attn = attn.masked_fill(cluster_mask.reshape(b, 1, n, -1) == 0, -torch.inf)
    attn = torch.softmax(torch.cat([attn, blank_attn], dim=-1), dim=-1)
    if drop is not None:
        attn = drop(attn)
    return cluster_av(attn[..., :-1], v, member_idx), attn[..., -1:]
