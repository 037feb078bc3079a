"""repro_torch — the Venn resource manager on PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``repro``, with the same structure
and names: ``core`` (VENN-SCHED, dispatch, supply), ``sim`` (event-driven
simulator and its two drain engines), ``obs`` (tracing, metrics, audit) and
``accel`` (the batched check-in matcher, its device-resident mirror, the
array replan and the two hand-written CUDA kernels under ``accel/kernels``),
and of the federated-learning substrate so far: ``configs``, ``models``
(parameters and the dense / audio forwards), ``kernels`` (FedAvg, int8
quantisation, flash attention), ``fed`` (compression, aggregation),
``train/optimizer``, ``serve`` and ``launch/serve``.

It imports ``torch`` and ``numpy`` only.  Entry points run on ``cuda:0``
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
