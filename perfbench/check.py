"""The comparison that decides ``correct``.

The program's answers, taken once the window has closed, against the plain
reference's replay of the same episode (``perfbench/reference``) over the
same jobs and stream, to the same simulated time:

* ``atom_mismatch``: check-ins whose atom (the set of requirements the
  device satisfies, as it stood when the check-in was decided) differs,
  plus check-ins the reference decided and the program never loaded;
* ``grant_mismatch``: grants ``(check-in, job, round)`` in one answer and
  not in the other;
* ``round_mismatch``: completed rounds (job, round, submit, allocation,
  completion, demand, responses, failures, retries, floats exact) in one
  answer and not in the other.

Every number is exact: the host state of the system is float64 and int64
and the program reproduces the per-device semantics bit for bit, so each
limit is 0 (``PERF.md`` gives the readings).
"""
from __future__ import annotations

from collections import Counter

import numpy as np

LIMITS = {"atom_mismatch": 0, "grant_mismatch": 0, "round_mismatch": 0}


def _codes(keys, names) -> np.ndarray:
    """Atom id -> a code of the requirement names in its key (-2 for a key
    that names no requirement of the configuration)."""
    bit = {nm: 1 << i for i, nm in enumerate(names)}
    return np.array([sum(bit[n] for n in k) if set(k) <= bit.keys() else -2
                     for k in keys] or [0], dtype=np.int64)


def _row_codes(loaded, keys, names, n_rows) -> np.ndarray:
    codes = _codes(keys, names)
    out = np.full(n_rows, -1, dtype=np.int64)
    for off, ids in loaded:
        if off < n_rows:
            ids = np.asarray(ids)[:n_rows - off]
            out[off:off + len(ids)] = codes[ids]
    return out


def _multiset_gap(a, b) -> int:
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def compare(prog: dict, ref: dict, times: np.ndarray, names) -> dict:
    """Numbers of one program episode against the reference replay of its
    episode (run at least as far).  ``times``: the whole stream's."""
    until = prog["until"]
    n_due = int(np.searchsorted(times, until, side="right"))
    p_codes = _row_codes(prog["loaded"], prog["atom_keys"], names, n_due)
    r_codes = _row_codes(ref["loaded"], ref["atom_keys"], names, n_due)
    atom = int(np.count_nonzero((p_codes != r_codes) | (p_codes < 0)))
    # the program logs a grant by its check-in time: find the row
    pg = prog["grants"]
    t = np.array([g[0] for g in pg], dtype=np.float64)
    rows = np.searchsorted(times, t)
    rows = np.minimum(rows, len(times) - 1)
    bad = times[rows] != t if len(t) else np.zeros(0, dtype=bool)
    rows = np.where(bad, -1, rows)
    p_grants = [(int(r), int(g[1]), int(g[2])) for r, g in
                zip(rows.tolist(), pg)]
    r_grants = [g for g in ref["grants"] if g[0] < n_due]
    r_rounds = [r for r in ref["rounds"] if r[4] <= until]
    return {"atom_mismatch": atom,
            "grant_mismatch": _multiset_gap(p_grants, r_grants),
            "round_mismatch": _multiset_gap(prog["rounds"], r_rounds),
            "checkins_compared": n_due,
            "grants_compared": len(r_grants),
            "rounds_compared": len(r_rounds)}


def as_program(ref: dict, times: np.ndarray, until: float) -> dict:
    """A reference replay's answers in the program's form, to ``until``:
    each grant by its check-in's time, as the program logs it, so that one
    replay can be held against another in the program's place."""
    return dict(ref, until=until,
                grants=[(float(times[r]), j, k) for r, j, k in ref["grants"]])


def total(results) -> dict:
    """Sum of the numbers over the episodes compared."""
    out: dict = {}
    for r in results:
        for k, v in r.items():
            out[k] = out.get(k, 0) + v
    return out


def verdict(numbers: dict) -> bool:
    return numbers.get("checkins_compared", 0) > 0 and \
        numbers.get("grants_compared", 0) > 0 and \
        all(numbers[k] <= lim for k, lim in LIMITS.items())
