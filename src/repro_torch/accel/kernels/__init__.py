"""Hand-written CUDA kernels of the scheduler's main path, each with its plain
PyTorch version beside it.  Sources are under ``csrc/``; :mod:`.build`
compiles them with ``nvcc`` for ``sm_90a`` at first use.  The matcher's
kernel is the module :mod:`.match_segment` (its wrapper has the module's
name, so it is not lifted here)."""
from .build import KernelCompileError, KernelError, KernelLaunchError
from .replan_order import (segmented_order, segmented_order_ref,
                           segmented_rank, segmented_rank_ref)
from .schedule_match import (first_fit_choice, first_fit_choice_ref,
                             masked_first_fit, masked_first_fit_ref)

__all__ = ["KernelCompileError", "KernelError", "KernelLaunchError",
           "first_fit_choice", "first_fit_choice_ref", "masked_first_fit",
           "masked_first_fit_ref", "segmented_order", "segmented_order_ref",
           "segmented_rank", "segmented_rank_ref"]
