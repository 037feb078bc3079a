"""Operations and bytes of one launch of the replan's resort kernel
``segmented_order`` (the entry of ``segmented_rank.cu`` that returns the
permutation), from the launch's shapes.

The replan resorts one group at a time: one segment of ``n`` jobs, keyed by
f64 demand key with int32 job ids as ties.  A row compares its segment id,
key and tie against every row of its segment (3 compares a same-segment
pair), after a binary search for the segment's bounds when segment ids are
sent.  Bytes: the keys (8), ties (4) and the permutation (4) a row, and the
segment ids (4 a row) when sent.
"""
import math

from .peaks import least_seconds


def work(n: int, segments=None):
    """``(bytes, operations)`` of a launch over ``n`` rows; ``segments``:
    the rows of each segment, or None for one segment (no ids sent)."""
    counts = [n] if segments is None else list(segments)
    same_pairs = sum(c * c for c in counts)
    multi = segments is not None and len(counts) > 1
    ops = 3 * same_pairs + (n * math.ceil(math.log2(n)) if multi else 0)
    nbytes = n * (8 + 4 + 4) + (4 * n if multi else 0)
    return nbytes, ops


def least_seconds_of(n: int, segments=None) -> float:
    return least_seconds(*work(n, segments))
