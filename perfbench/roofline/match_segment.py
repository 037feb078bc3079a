"""Operations and bytes of one launch of the matcher kernel
``match_segment`` (one drain segment's eligibility and fill-position fixed
point), from the launch's shapes.

Bytes it must move: the rows' atom ids (4) and speeds (8); the candidate
rows of the distinct atoms the segment names, ``K`` slots each of request
index (4) and speed band (8 + 8); the ``R`` requests' remaining demand (4);
the live-row indices (4 a row) when the segment sends them; the outputs,
choice and granted a row and two words.  Operations: the two f64 band
compares of every (row, slot).  Each byte is counted once, whatever the
kernel reads again.
"""
from .peaks import least_seconds


def work(n: int, k: int, r: int, atoms: int, live: bool):
    """``(bytes, operations)`` of a launch over ``n`` rows, ``k`` slots a
    row, ``r`` requests and ``atoms`` distinct atoms."""
    nbytes = n * (4 + 8) + atoms * k * (4 + 8 + 8) + 4 * r \
        + (4 * n if live else 0) + 4 * (2 * n + 2)
    return nbytes, 2 * n * k


def least_seconds_of(n: int, k: int, r: int, atoms: int, live: bool) -> float:
    return least_seconds(*work(n, k, r, atoms, live))
