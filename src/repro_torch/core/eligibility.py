"""Eligibility index: maps devices <-> requirements via capability *atoms*.

The IRS problem (§4.2) is a set system where each job group's eligible set
``S_j`` may include / overlap / nest with others.  We factor the device
universe into **atoms** — equivalence classes of devices by the exact subset of
requirements they satisfy.  Every eligible set is then a union of atoms, and
Algorithm 1's set operations (``S ∩ S_j``, ``S \\ S'_j``, ``S_j ∩ S_k``) become
cheap frozenset algebra over atom keys.

Fast path: every realized atom is **interned** to a dense int id, and the
requirement thresholds are kept as a ``(R, C)`` min-threshold matrix so that
classifying a whole chunk of devices is one NumPy broadcast comparison
(``caps[:, None, :] >= mins[None, :, :]``) instead of per-device Python
generator calls.  Frozenset keys remain the boundary representation (plans,
supply estimation, tests); ids are what the per-check-in hot path touches.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence

import numpy as np

from .interning import AtomInterner
from .types import Device, Requirement

AtomKey = FrozenSet[str]


class EligibilityIndex:
    """Precomputes atom membership for a fixed set of requirements.

    Atoms are keyed by the frozenset of requirement names a device satisfies.
    With R distinct requirements there are at most 2^R atoms, but the device
    population only ever realizes a handful (4 in the paper's Figure 8a).

    ``version`` increments whenever a requirement is added (the atom partition
    refines); callers caching classification results must re-classify when it
    changes.
    """

    def __init__(self, requirements: Sequence[Requirement],
                 interner: Optional[AtomInterner] = None):
        self.requirements: List[Requirement] = list(requirements)
        self._by_name: Dict[str, Requirement] = {r.name: r for r in self.requirements}
        if len(self._by_name) != len(self.requirements):
            raise ValueError("duplicate requirement names")
        self.version: int = 0
        # ---- interning state: shared dense atom id <-> frozenset key map
        # (the same interner backs the supply estimator, so index ids are
        # valid everywhere — no translation LUTs)
        self.interner = interner if interner is not None else AtomInterner()
        # ---- vectorized threshold matrix (R requirements x C capability dims)
        self._cap_names: List[str] = []
        self._mins: np.ndarray = np.zeros((0, 0))
        # ---- classification cache: satisfaction-code -> interned atom id,
        # valid for one ``version`` (the atom partition).  Replans re-classify
        # chunk tails repeatedly between version bumps; with the cache those
        # calls skip the per-code frozenset construction + intern entirely.
        # -1 marks a code not yet realized; new codes are interned in
        # ascending-code order, exactly matching the uncached visit order,
        # so atom-id assignment is bit-identical with or without the cache.
        self._clf_version = -1
        self._clf_lut: Optional[np.ndarray] = None
        self._rebuild_arrays()

    # ------------------------------------------------------------- interning

    @property
    def num_atoms(self) -> int:
        return len(self.interner)

    def intern(self, key: AtomKey) -> int:
        """Dense id for an atom key (assigning one on first sight)."""
        return self.interner.intern(key)

    def key_of(self, atom_id: int) -> AtomKey:
        return self.interner.key_of(atom_id)

    def id_of(self, key: AtomKey) -> Optional[int]:
        return self.interner.id_of(key)

    # ---------------------------------------------------------------- atoms

    def atom_of(self, device: Device) -> AtomKey:
        key = frozenset(r.name for r in self.requirements if r.matches(device))
        device.atom = key
        device.atom_id = self.intern(key)
        return key

    def atom_id_of(self, device: Device) -> int:
        self.atom_of(device)
        return device.atom_id  # type: ignore[return-value]

    def classify(self, caps: Dict[str, np.ndarray]) -> np.ndarray:
        """Vectorized ``atom_of`` over a struct-of-arrays device chunk.

        ``caps`` maps capability name -> value array (missing capability dims
        are treated as 0, matching ``Requirement.matches``).  Returns an int64
        array of interned atom ids, one per device.
        """
        n = len(next(iter(caps.values()))) if caps else 0
        R = len(self.requirements)
        if R == 0 or n == 0:
            return np.full(n, self.intern(frozenset()), dtype=np.int64)
        mat = np.zeros((n, len(self._cap_names)))
        for j, name in enumerate(self._cap_names):
            arr = caps.get(name)
            if arr is not None:
                mat[:, j] = arr
        sat = (mat[:, None, :] >= self._mins[None, :, :]).all(axis=2)  # (n, R)
        names = [r.name for r in self.requirements]
        if R <= 16:
            # encode each satisfaction row as one small int and intern via a
            # dense 2^R LUT filled lazily and kept across calls while the
            # partition version holds: O(n) per call, no sort, and repeat
            # classifications (replan-boundary chunk-tail reclassifies) skip
            # the frozenset construction + intern entirely.  New codes are
            # interned ascending, matching the uncached visit order bit for
            # bit, so atom-id assignment is unchanged.
            codes = sat @ (np.int64(1) << np.arange(R, dtype=np.int64))
            lut = self._clf_lut
            if lut is None or self._clf_version != self.version:
                lut = self._clf_lut = np.full(1 << R, -1, dtype=np.int64)
                self._clf_version = self.version
            out = lut[codes]
            if (out >= 0).all():
                return out
            for code in np.unique(codes[out < 0]).tolist():
                key = frozenset(nm for b, nm in enumerate(names) if code >> b & 1)
                lut[code] = self.intern(key)
            return lut[codes]
        if R <= 63:
            # encode each satisfaction row as one int: 1D unique is far
            # cheaper than the axis=0 structured-view path
            codes = sat @ (np.int64(1) << np.arange(R, dtype=np.int64))
            uniq, inverse = np.unique(codes, return_inverse=True)
            lut = np.empty(len(uniq), dtype=np.int64)
            for u, code in enumerate(uniq.tolist()):
                key = frozenset(nm for b, nm in enumerate(names) if code >> b & 1)
                lut[u] = self.intern(key)
        else:
            packed = np.packbits(sat, axis=1)
            uniq, inverse = np.unique(packed, axis=0, return_inverse=True)
            lut = np.empty(len(uniq), dtype=np.int64)
            for u in range(len(uniq)):
                bits = np.unpackbits(uniq[u])[:R]
                lut[u] = self.intern(frozenset(nm for nm, b in zip(names, bits) if b))
        return lut[inverse.ravel()]

    def eligible_atoms(self, requirement: Requirement, atoms: Iterable[AtomKey]) -> FrozenSet[AtomKey]:
        """Atoms whose devices satisfy ``requirement`` (atom contains req name)."""
        name = requirement.name
        return frozenset(a for a in atoms if name in a)

    def add_requirement(self, requirement: Requirement) -> None:
        if requirement.name in self._by_name:
            existing = self._by_name[requirement.name]
            if existing.mins != requirement.mins:
                raise ValueError(f"requirement name reused with different spec: {requirement.name}")
            return
        self.requirements.append(requirement)
        self._by_name[requirement.name] = requirement
        self._rebuild_arrays()

    def requirement(self, name: str) -> Requirement:
        return self._by_name[name]

    def _rebuild_arrays(self) -> None:
        cap_names: List[str] = []
        seen = set()
        for r in self.requirements:
            for cap, _ in r.mins:
                if cap not in seen:
                    seen.add(cap)
                    cap_names.append(cap)
        self._cap_names = cap_names
        # -inf marks "no constraint on this dim" (a 0.0 min would wrongly
        # reject negative capability values).
        mins = np.full((len(self.requirements), len(cap_names)), -np.inf)
        col = {c: j for j, c in enumerate(cap_names)}
        for i, r in enumerate(self.requirements):
            for cap, lo in r.mins:
                mins[i, col[cap]] = lo
        self._mins = mins
        self.version += 1

    # ------------------------------------------------------------- analysis

    def relation(self, a: Requirement, b: Requirement) -> str:
        """Classify the eligible-set relation between two requirements:
        one of {'equal', 'contains', 'within', 'overlap', 'disjoint'} judged
        from thresholds (exact for min-threshold requirements)."""
        if a.mins == b.mins:
            return "equal"
        if a.subsumes(b):
            return "contains"
        if b.subsumes(a):
            return "within"
        # min-threshold boxes always intersect at the pointwise-max corner,
        # so two distinct threshold requirements overlap.
        return "overlap"
