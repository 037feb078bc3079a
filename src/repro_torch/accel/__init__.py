"""Array-native scheduler engine: batched check-in matching on the device.

``repro_torch.accel`` turns the per-device ``checkin`` loop into per-segment
array programs over struct-of-arrays mirrors of the scheduler state:

* :mod:`.state`   — ``MatchState`` (dense candidate-slot mirrors, the three
  candidate matrices the matcher reads kept a second time on the device)
  and ``SupplyRings`` (stacked supply windows);
* :mod:`.engine`  — ``match_chunk_torch`` (the fill-position fixed-point
  matcher: the kernel on a card, its plain version on the CPU), the
  sequential oracle ``match_chunk_seq`` and ``ArrayMatchEngine``
  (simulator-facing);
* :mod:`.match`   — the fixed point as a torch program (the plain version
  of the matcher's kernel);
* :mod:`.replan`  — VENN-SCHED on incrementally maintained arrays;
* :mod:`.kernels` — the CUDA kernels (the one-launch matcher
  ``match_segment``; masked first-fit, the reference's contract form of its
  step; segmented rank / order) with their plain PyTorch versions.
"""
from .engine import (ArrayMatchEngine, MatchResult, match_chunk_seq,
                     match_chunk_torch)
from .state import MatchState, SupplyRings, match_state_from_numpy

__all__ = ["ArrayMatchEngine", "MatchResult", "MatchState", "SupplyRings",
           "match_chunk_seq", "match_chunk_torch",
           "match_state_from_numpy"]
