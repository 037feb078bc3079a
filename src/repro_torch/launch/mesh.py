"""Meshes and the H100's published figures, which the roofline divides by.

A mesh here is a description: a small frozen :class:`Mesh` of a shape, axis
names and the devices it covers.  It is not a ``torch.distributed``
``DeviceMesh``, which needs an initialised process group that the port's
one-process trainer and server do not have.  Defined as functions, as in
the reference (``repro/launch/mesh.py``), so that importing this module
touches no device.

``make_host_mesh`` covers the cards this process sees, ``(n // model,
model)`` over ``("data", "model")``; ``make_production_mesh`` gives the
H100 layout of the reference's two production meshes, for the records:
256 cards as ``(32, 8)`` with ``"model"`` inside one 8-card NVLink node,
and a second such pod in front (``(2, 32, 8)`` over ``("pod", "data",
"model")``).  Nothing traces them: the sharding rules they would need
(``dist``) are in neither package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from ..device import DeviceLike, default_device

# NVIDIA H100 SXM, dense rates without sparsity, at the full 700 W limit
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80e9                  # 80 GB of HBM3
# NVLink 4, one direction, per card: the reference's ICI_BW (its per-device
# collective bandwidth)
LINK_BW = 450e9                   # B/s


@dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]   # () for a layout kept for the records

    @property
    def size(self) -> int:
        """Number of cards the layout spans."""
        return math.prod(self.shape)

    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, ())


def make_host_mesh(model: int = 1, device: DeviceLike = None) -> Mesh:
    """The cards this process sees (``None`` or ``"cuda"``: every CUDA
    device, an error without one); a device with an index, ``"cpu"`` or
    ``"meta"``: that one device (``device="cpu"``: the host; the dry-run's
    one traced card)."""
    if device is None or torch.device(device) == torch.device("cuda"):
        default_device()                          # raises without a card
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    else:
        devices = (torch.device(device),)
    n = len(devices)
    model = min(model, n)
    return Mesh((n // model, model), ("data", "model"), devices)
