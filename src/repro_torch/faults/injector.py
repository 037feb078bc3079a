"""FaultInjector — compose a :class:`FaultPlan` onto any ChunkStream.

The injector is a three-layer pipeline mirroring a real ingest path, each
layer a deterministic function of the plan's seed:

1. **flaky read** — each pull of an inner chunk fails transiently with
   ``fail_prob`` and is retried with exponential backoff (accounted in
   ``backoff_total_s``, never slept); exhausting ``max_retries`` abandons
   that chunk (graceful data loss, counted) and moves on.
2. **transport chaos** — successfully read chunks are sequence-numbered and
   then dropped, duplicated, or adjacent-swapped per ``ChunkChaos``.
3. **ingest recovery + row faults** — a sequence-number watermark discards
   duplicates and a two-chunk lookahead restores adjacent reorders (so dup
   and reorder alone are outcome-transparent: bit-identical metrics, nonzero
   counters).  Surviving chunks then take row-level faults: blackout-window
   drops, clock skew (late rows crossing the chunk's original end are carried
   into later chunks, preserving the stream's cross-chunk time ordering), and
   NaN speed corruption.

The injector satisfies the :class:`~repro_torch.sim.devices.ChunkStream` contract
(time-sorted rows, non-decreasing across chunks) for *any* plan, and is
picklable so crash snapshots capture mid-stream fault state exactly.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..obs import trace as _obstrace
from ..sim.devices import ChunkStream, DeviceChunk
from .plan import FaultPlan

_COLS = ("times", "cpu", "mem", "speed", "resp_z", "fail_u")


class FaultInjector:
    """Wrap ``inner`` so its chunks pass through the plan's fault pipeline.

    ``plan`` must be absolute (``fractional=False``) — use
    :meth:`FaultPlan.resolve` or the :func:`repro_torch.faults.inject` helper.
    """

    def __init__(self, inner: ChunkStream, plan: FaultPlan):
        if plan.fractional:
            raise ValueError(
                "FaultInjector needs an absolute plan; call "
                "plan.resolve(horizon) first (windows are horizon fractions)")
        plan.validate()
        self.inner = inner
        self.plan = plan
        self.fail_base = inner.fail_base
        self.fail_slow_boost = inner.fail_slow_boost
        self._rng = np.random.default_rng(plan.seed)
        # ---- transport state ----
        self._next_seq = 0
        self._inner_eof = False
        self._out: List[Tuple[int, DeviceChunk]] = []   # pending deliveries
        self._hold: Optional[Tuple[int, DeviceChunk]] = None  # reorder hold
        # ---- ingest state ----
        self._buf: List[Tuple[int, DeviceChunk]] = []   # lookahead (size <= 2)
        self._last_seq = -1
        self._carry: Optional[Tuple[np.ndarray, ...]] = None  # skew overflow
        # ---- counters ----
        self.flaky_failures = 0        # transient read failures (incl. retries)
        self.flaky_retries = 0         # retry attempts issued
        self.flaky_giveups = 0         # chunks abandoned after max_retries
        self.backoff_total_s = 0.0     # accounted exponential-backoff time
        self.chunks_dropped = 0        # transport drops (real loss)
        self.chunks_duplicated = 0     # transport retransmissions
        self.chunks_reordered = 0      # transport adjacent swaps
        self.dup_chunks_discarded = 0  # ingest dedup hits
        self.rows_dropped_chunks = 0   # rows lost to dropped/abandoned chunks
        self.rows_dropped_blackout = 0 # rows dropped inside blackout windows
        self.skewed_rows = 0
        self.corrupt_rows = 0          # speed readings NaNed
        self.carried_rows = 0          # skewed rows pushed into later chunks

    # ----------------------------------------------------------- layer 1: read

    def _flaky_read(self) -> Optional[DeviceChunk]:
        """Pull one inner chunk through the flaky-read model.  Returns None
        only at true end-of-stream; unreadable chunks are abandoned (counted)
        and the read moves on."""
        fi = self.plan.flaky_ingest
        if fi is None or fi.fail_prob <= 0.0:
            return self.inner.next_chunk()
        tr = _obstrace.TRACER
        while True:
            attempt = 0
            while self._rng.random() < fi.fail_prob:
                self.flaky_failures += 1
                if attempt >= fi.max_retries:
                    break
                self.flaky_retries += 1
                self.backoff_total_s += fi.backoff * (2.0 ** attempt)
                if tr.enabled:
                    tr.instant("fault.flaky_retry", cat="fault",
                               attempt=attempt,
                               backoff_s=fi.backoff * (2.0 ** attempt))
                attempt += 1
            else:
                return self.inner.next_chunk()
            # retries exhausted: the segment is unreadable — skip it
            self.flaky_giveups += 1
            ck = self.inner.next_chunk()
            if ck is None:
                return None
            if tr.enabled:
                tr.instant("fault.flaky_giveup", cat="fault", rows=ck.n)
            self.rows_dropped_chunks += ck.n

    # ------------------------------------------------------ layer 2: transport

    def _transport_next(self) -> Optional[Tuple[int, DeviceChunk]]:
        cc = self.plan.chunk_chaos
        rng = self._rng
        while True:
            if self._out:
                return self._out.pop(0)
            if self._inner_eof:
                if self._hold is not None:
                    d, self._hold = self._hold, None
                    return d
                return None
            ck = self._flaky_read()
            if ck is None:
                self._inner_eof = True
                continue
            seq = self._next_seq
            self._next_seq += 1
            if cc is not None and cc.drop_prob > 0.0 \
                    and rng.random() < cc.drop_prob:
                self.chunks_dropped += 1
                self.rows_dropped_chunks += ck.n
                tr = _obstrace.TRACER
                if tr.enabled:
                    tr.instant("fault.chunk_drop", cat="fault", rows=ck.n)
                continue
            d = (seq, ck)
            dup = cc is not None and cc.dup_prob > 0.0 \
                and rng.random() < cc.dup_prob
            reorder = cc is not None and cc.reorder_prob > 0.0 \
                and rng.random() < cc.reorder_prob
            if self._hold is not None:
                # release the held chunk *after* this one: an adjacent swap
                self._out.append(d)
                if dup:
                    self.chunks_duplicated += 1
                    self._out.append(d)
                self._out.append(self._hold)
                self._hold = None
                self.chunks_reordered += 1
            elif reorder:
                self._hold = d
                if dup:
                    self.chunks_duplicated += 1
                    self._out.append(d)
            else:
                self._out.append(d)
                if dup:
                    self.chunks_duplicated += 1
                    self._out.append(d)

    # -------------------------------------------------------- layer 3: ingest

    def _ingest_next(self) -> Optional[DeviceChunk]:
        """Dedup by sequence watermark + restore adjacent reorders with a
        two-delivery lookahead (transport displaces a chunk by at most one
        position, so sorting a 2-buffer by seq recovers the original order)."""
        while len(self._buf) < 2:
            d = self._transport_next()
            if d is None:
                break
            seq = d[0]
            if seq <= self._last_seq or any(s == seq for s, _ in self._buf):
                self.dup_chunks_discarded += 1
                continue
            self._buf.append(d)
        if not self._buf:
            return None
        self._buf.sort(key=lambda d: d[0])
        seq, ck = self._buf.pop(0)
        self._last_seq = seq
        return ck

    # ------------------------------------------------------------- row faults

    def _apply_row_faults(self, ck: DeviceChunk) -> Optional[DeviceChunk]:
        plan = self.plan
        rng = self._rng
        orig_end = float(ck.times[-1])
        cols = [np.asarray(getattr(ck, c), dtype=np.float64) for c in _COLS]
        times = cols[0]
        n = len(times)
        keep = np.ones(n, dtype=bool)
        for b in plan.blackouts:
            in_win = (times >= b.start) & (times < b.stop)
            if not in_win.any():
                continue
            if b.drop_prob >= 1.0:
                drop = in_win
            else:
                drop = in_win & (rng.random(n) < b.drop_prob)
            self.rows_dropped_blackout += int(drop.sum())
            keep &= ~drop
        if not keep.all():
            cols = [c[keep] for c in cols]
            times = cols[0]
            n = len(times)
        cs = plan.clock_skew
        if cs is not None and cs.fraction > 0.0 and n:
            pick = rng.random(n) < cs.fraction
            if pick.any():
                delta = rng.uniform(0.0, cs.max_skew, size=n)
                times = times.copy()
                times[pick] += delta[pick]
                cols[0] = times
                self.skewed_rows += int(pick.sum())
        cc = plan.chunk_chaos
        if cc is not None and cc.corrupt_speed_prob > 0.0 and n:
            bad = rng.random(n) < cc.corrupt_speed_prob
            if bad.any():
                speed = cols[3].copy()
                speed[bad] = np.nan
                cols[3] = speed
                self.corrupt_rows += int(bad.sum())
        # merge carried-over late rows from earlier chunks (all of which are
        # <= this chunk's rows' possible range: carried times exceed their own
        # chunk's original end, which bounds this chunk's rows from below)
        if self._carry is not None:
            cols = [np.concatenate([c, cc_]) for c, cc_ in
                    zip(cols, self._carry)]
            self._carry = None
            times = cols[0]
            n = len(times)
        if n == 0:
            return None
        order = np.argsort(times, kind="stable")
        cols = [c[order] for c in cols]
        times = cols[0]
        # rows skewed past this chunk's original end would break the
        # cross-chunk ordering contract; carry them into the next chunk
        cut = int(np.searchsorted(times, orig_end, side="right"))
        if cut < n:
            self._carry = tuple(c[cut:] for c in cols)
            self.carried_rows += n - cut
            cols = [c[:cut] for c in cols]
            if cut == 0:
                return None
        return DeviceChunk(*cols)

    def _flush_carry(self) -> Optional[DeviceChunk]:
        if self._carry is None:
            return None
        cols, self._carry = self._carry, None
        return DeviceChunk(*cols) if len(cols[0]) else None

    # ---------------------------------------------------------------- stream

    def next_chunk(self) -> Optional[DeviceChunk]:
        while True:
            ck = self._ingest_next()
            if ck is None:
                return self._flush_carry()
            if ck.n == 0:
                continue
            out = self._apply_row_faults(ck)
            if out is not None and out.n:
                return out

    @property
    def gen(self):
        """Expose the wrapped generator (simulator/device-model discovery)."""
        return getattr(self.inner, "gen", None)

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    # -------------------------------------------------------------- counters

    def fault_counters(self) -> dict:
        return {
            "flaky_failures": self.flaky_failures,
            "flaky_retries": self.flaky_retries,
            "flaky_giveups": self.flaky_giveups,
            "backoff_total_s": self.backoff_total_s,
            "chunks_dropped": self.chunks_dropped,
            "chunks_duplicated": self.chunks_duplicated,
            "chunks_reordered": self.chunks_reordered,
            "dup_chunks_discarded": self.dup_chunks_discarded,
            "rows_dropped_chunks": self.rows_dropped_chunks,
            "rows_dropped_blackout": self.rows_dropped_blackout,
            "skewed_rows": self.skewed_rows,
            "corrupt_rows": self.corrupt_rows,
            "carried_rows": self.carried_rows,
        }

    @property
    def dropped_checkins(self) -> int:
        """Total check-in rows the faults removed from the stream."""
        return (self.rows_dropped_blackout + self.rows_dropped_chunks)


def inject(stream: ChunkStream, plan: FaultPlan,
           horizon: Optional[float] = None) -> FaultInjector:
    """Convenience wrapper: resolve ``plan`` against ``horizon`` (when it is
    fractional) and compose it onto ``stream``."""
    if plan.fractional:
        if horizon is None:
            raise ValueError("fractional plan needs a horizon to resolve")
        plan = plan.resolve(horizon)
    return FaultInjector(stream, plan)
