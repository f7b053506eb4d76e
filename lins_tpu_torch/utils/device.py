"""Device and dtype rules shared by the port's entry points and loops."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The entry points' device: the card unless the caller names another.

    Raises when the card is asked for (explicitly or by default) and none is
    present: the port never drops to the CPU by itself.  Also turns TF32
    off: 10-bit mantissas pick wrong nearest neighbours in the association
    distance products (odometry/association.py).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lins_tpu_torch: no CUDA device; pass device='cpu' to run on "
            "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """Filter dtype: float32 unless given (the CPU parity tests pass
    float64)."""
    return torch.float32 if dtype is None else dtype


def may_stop(active: torch.Tensor) -> bool:
    """Whether a data-dependent loop (the scan-to-map GN, the loop ICP)
    ends before its next trip: the host reads the 0-dim flag `active` (one
    copy, which waits for the trip that set it), on every device, and
    issues no trip once it is false.  Call it before each trip after the
    first, since `active` starts true.  The loops still freeze their carry
    on the device where `active` is false, so a loop made to run all its
    trips (as the tests force it) gives the same result, bit for bit."""
    return not bool(active)
