"""Device selection and dtype policy — the one place both are decided.

Device: every entry point (``Simulator``, ``ArrayMatchEngine``,
``VennScheduler``, ``run_workload``) takes one optional ``device=`` argument.
``None`` means :func:`default_device`, which is ``cuda:0`` and **raises** when
no CUDA device is present; the CPU is used only when the caller asks for it
by passing ``device="cpu"`` (the CPU tests do).  Nothing in the package
quietly moves work to the CPU because a card is missing.

Dtypes on the device:

* ids and positions (atom ids, request indices, fill positions, ranks) are
  ``int32`` — and ``int64`` again at the host boundary, which is what the
  NumPy callers index and ``bincount`` with;
* counters are ``int64``;
* every float that decides anything (tier speed bands, check-in speeds,
  demand keys) is ``float64``: the host code compares Python floats, the
  H100 has native f64, and a band edge rounded to f32 can move a grant.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def default_device() -> torch.device:
    """``cuda:0``; raises ``RuntimeError`` when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device=\"cpu\" to run the host-only path explicitly")
    return torch.device("cuda", 0)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else is taken as asked."""
    if device is None:
        return default_device()
    return torch.device(device)
