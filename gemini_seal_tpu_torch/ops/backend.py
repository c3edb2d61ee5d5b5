"""Device placement and the residue substrate.

Residues are u64 values.  torch has no unsigned 64-bit add, shift or
compare, so every residue tensor is ``torch.int64`` holding the u64 bit
pattern: an int64 multiply, add or subtract wraps exactly like the u64 one,
and the plain versions in :mod:`.modops` build the logical shift and the
unsigned compare on top.  Host arrays cross as ``np.uint64`` views.

Dispatch rule shared by every kernel wrapper: a tensor on the CPU runs the
plain PyTorch version, a tensor on a CUDA device launches the hand-written
kernel (or raises), any other device raises.  The one exception is the
explicit :func:`plain_versions` scope, which runs the plain versions on the
card so that a check can hold the kernels against them on the same inputs.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

__all__ = ["resolve_device", "to_tensor", "to_numpy", "is_cuda",
           "plain_versions"]

_PLAIN = contextvars.ContextVar("gst_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Within this scope every wrapper runs its plain PyTorch version, on
    whatever device its tensors lie: the reference path that chip_smoke.py
    and the card tests compare the kernels with."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present; the entry points never continue on the CPU unless asked to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_tensor(arr, device) -> torch.Tensor:
    """u64 array-like -> contiguous int64 tensor of the same bit pattern."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 residue tensor -> np.uint64 array of the same bit pattern."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def is_cuda(*tensors: torch.Tensor) -> bool:
    """True when the call must launch a kernel, False for the plain version.

    All tensors of one call share a device; anything but CPU or CUDA raises.
    """
    types = {t.device.type for t in tensors}
    if len(types) != 1 or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on mixed devices: {[str(t.device) for t in tensors]}")
    (kind,) = types
    if kind == "cuda":
        return not _PLAIN.get()
    if kind == "cpu":
        return False
    raise ValueError(f"unsupported device type {kind}")
