"""Hand-written CUDA kernels of the federated server round — FedAvg
reduction and int8 block quantisation both ways — and of serving — flash
attention for prefill — each with its plain PyTorch version (:mod:`.ref`,
and ``flash_attention_plain`` beside its kernel) and launch counter.
Sources are under ``csrc/``; ``repro_torch.accel.kernels.build`` compiles
them with the scheduler's kernels, with ``nvcc`` for ``sm_90a``, at first
use."""
from . import ops, ref

__all__ = ["ops", "ref"]
