"""The fill-position fixed point as a torch program: the plain version of
the matcher's kernel.

The counterpart of the reference's jitted ``_match_jax`` (a
``lax.while_loop`` on padded shapes).  Torch runs eagerly, so there is no
padding: the tensors have the segment's own ``(n, K)`` and ``(R,)`` shapes.
A round costs one host sync (the convergence test), and the loop gives up
after ``R + 2`` rounds (the proven bound) and says so.  On a CUDA device the
engine runs the whole loop as one launch of
:mod:`repro_torch.accel.kernels.match_segment` instead; this program is that
kernel's plain version (``match_segment_ref``), which the CPU path runs and
the card's checks hold the kernel against.

One round:

1. ``choice_of``  — masked first-fit over the candidate matrix, gathering
   ``fill[reqix]`` (the first-fit kernel's plain version,
   :func:`repro_torch.accel.kernels.schedule_match.first_fit_choice_ref`,
   so that the program holds no kernel of this package);
2. ``ranks_of``   — stable sort by chosen request (``torch.sort(stable=True)``
   equals the reference's ``lexsort((pos, ch_key))`` because ``pos`` is
   ``arange``); a row's group starts where its key first occurs in the sorted
   keys (``searchsorted`` of the keys in themselves, what the reference gets
   from a ``cummax`` over group flags), rank = offset within the group;
3. ``fills_of``   — each request's fill position is the position of its
   ``rem[r]``-th chooser: at most one such row per request, so the scatter has
   no write races; rows that are no request's last chooser are written to a
   spare slot ``R`` of the ``R + 1`` long buffers (the reference's
   ``mode="drop"``).  The spare slot's remaining demand is 0, which also makes
   rows without a choice (sort key ``R``) fall out of every comparison without
   a separate validity mask.

On a card a round is about fifteen small launches and a sync; their
latency, not bandwidth, is what a segment costs — the reason for the
one-launch kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernels.schedule_match import first_fit_choice_ref


def match_fixed_point(reqix: torch.Tensor, elig: torch.Tensor,
                      rem_ext: torch.Tensor
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor], int]:
    """``reqix`` ``(n, K)`` int32 candidate request indices (``-1`` padded),
    ``elig`` ``(n, K)`` bool (true only where ``reqix >= 0``), ``rem_ext``
    ``(R + 1,)`` int32: the remaining demand of the ``R`` requests followed
    by one ``0`` (the spare slot), all on one device; ``n, K, R >= 1``.

    Returns ``(choice, granted, rounds)``: ``(n,)`` int32 and bool tensors on
    the same device, or ``(None, None, rounds)`` if the fixed point did not
    settle within ``R + 2`` rounds."""
    n, K = reqix.shape
    R = rem_ext.shape[0] - 1
    dev = reqix.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    # fill positions; slot R (rem 0) starts at -1 and only ever receives -1
    fill0 = torch.where(rem_ext > 0, n, -1).to(torch.int32)
    cur = fill0
    for it in range(1, R + 3):
        _, choice = first_fit_choice_ref(elig, reqix, cur[:R], pos)
        # stable (request, position) sort -> per-request chooser ranks; rows
        # without a choice sort last under key R, whose rem is 0, so they are
        # never a last chooser and never granted
        ch_s, order = torch.sort(torch.where(choice >= 0, choice, R),
                                 stable=True)
        rank = pos - torch.searchsorted(ch_s, ch_s, out_int32=True)
        remg = rem_ext[ch_s.long()]
        is_last = rank == remg - 1
        new = fill0.scatter(0, torch.where(is_last, ch_s, R).long(),
                            torch.where(is_last, order, -1).to(torch.int32))
        if torch.equal(new, cur):            # the round's one host sync
            granted = torch.empty(n, dtype=torch.bool, device=dev)
            granted[order] = rank < remg
            return choice, granted, it
        cur = new
    return None, None, R + 2
