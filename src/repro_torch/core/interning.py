"""Shared atom interning: one dense id space for every atom consumer.

The fast path indexes everything by dense atom ids (dispatch tables, supply
ring buffers, liveness bitmaps).  Before this module, :class:`EligibilityIndex`
and :class:`~repro_torch.core.supply.SupplyEstimator` each interned their own keys
and the manager bridged them with a translation LUT; a single shared
:class:`AtomInterner` makes the index's ids *the* ids everywhere, so batch
feeds cross module boundaries with no per-replan id remapping.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional

AtomKey = FrozenSet[str]


class AtomInterner:
    """Bijective atom key <-> dense int id map (append-only)."""

    __slots__ = ("_id_by_key", "_key_by_id")

    def __init__(self) -> None:
        self._id_by_key: Dict[AtomKey, int] = {}
        self._key_by_id: List[AtomKey] = []

    def __len__(self) -> int:
        return len(self._key_by_id)

    def intern(self, key: AtomKey) -> int:
        """Dense id for an atom key (assigning one on first sight)."""
        aid = self._id_by_key.get(key)
        if aid is None:
            aid = len(self._key_by_id)
            self._id_by_key[key] = aid
            self._key_by_id.append(key)
        return aid

    def key_of(self, atom_id: int) -> AtomKey:
        return self._key_by_id[atom_id]

    def id_of(self, key: AtomKey) -> Optional[int]:
        return self._id_by_key.get(key)

    def keys(self) -> List[AtomKey]:
        """All interned keys, in id order (a copy)."""
        return list(self._key_by_id)
