"""Trace recording & replay: file-backed device check-in streams.

Two cooperating pieces behind the :class:`~repro_torch.sim.devices.ChunkStream`
protocol:

* :class:`RecordingStream` wraps any stream and appends every chunk it yields
  to a trace file, so *any* synthetic run (plain population, scenario,
  whatever) becomes a replayable artifact.
* :class:`TraceReplayStream` streams a trace file back as struct-of-arrays
  chunks — reading ``chunk_rows`` rows at a time, never materializing the
  file, so million-device traces replay in bounded memory.

Formats (chosen by file suffix, ``.jsonl`` vs anything else = CSV):

* CSV — ``#``-prefixed header comments carrying the failure-model params,
  one ``time,cpu,mem,speed,resp_z,fail_u`` header row, then one row per
  check-in.  Floats are written with ``repr`` so values round-trip exactly:
  a recorded run replays to bit-identical metrics.
* JSONL — a header object on line 1 (``{"format": "venn-trace", ...}``),
  then one JSON array per check-in.

External (FedScale-style) availability traces only need a ``time`` column;
missing capability/speed columns fall back to neutral defaults and missing
randomness columns (``resp_z`` / ``fail_u``) are synthesized from a seeded
RNG, so a bare list of check-in timestamps is already a valid trace.
"""
from __future__ import annotations

import json
import math
from typing import IO, Dict, List, Optional

import numpy as np

from ..sim.devices import ChunkStream, DeviceChunk, PopulationConfig

FORMAT_NAME = "venn-trace"
FORMAT_VERSION = 1
COLUMNS = ("time", "cpu", "mem", "speed", "resp_z", "fail_u")
_ALIASES = {"timestamp": "time", "t": "time"}
_DEFAULTS = {"cpu": 4.0, "mem": 4.0, "speed": 1.0}


def _is_jsonl(path: str) -> bool:
    return path.endswith(".jsonl")


# --------------------------------------------------------------------------- #
# Recording
# --------------------------------------------------------------------------- #

class RecordingStream:
    """Wrap ``inner`` and dump every chunk it yields to ``path``.

    The file is finalized when the inner stream ends (or on :meth:`close` /
    context-manager exit).  Chunks pass through untouched, so recording a run
    does not perturb it.  By default :meth:`close` *drains* the inner stream
    first — a run that finishes before the horizon still records the full
    device stream, so the trace is consumer-independent (a slower scheduler
    replaying it cannot run out of devices early)."""

    def __init__(self, inner: ChunkStream, path: str, drain_on_close: bool = True):
        self.inner = inner
        self.path = path
        self.fail_base = inner.fail_base
        self.fail_slow_boost = inner.fail_slow_boost
        self.rows_written = 0
        self._drain_on_close = drain_on_close
        self._jsonl = _is_jsonl(path)
        self._fh: Optional[IO[str]] = open(path, "w")
        self._write_header()

    def _write_header(self) -> None:
        assert self._fh is not None
        if self._jsonl:
            self._fh.write(json.dumps({
                "format": FORMAT_NAME, "version": FORMAT_VERSION,
                "fail_base": self.fail_base,
                "fail_slow_boost": self.fail_slow_boost,
                "columns": list(COLUMNS),
            }) + "\n")
        else:
            self._fh.write(f"# {FORMAT_NAME} v{FORMAT_VERSION}\n")
            self._fh.write(f"# fail_base={self.fail_base!r}\n")
            self._fh.write(f"# fail_slow_boost={self.fail_slow_boost!r}\n")
            self._fh.write(",".join(COLUMNS) + "\n")

    def _write(self, ck: DeviceChunk) -> None:
        assert self._fh is not None
        cols = [ck.times.tolist(), ck.cpu.tolist(), ck.mem.tolist(),
                ck.speed.tolist(), ck.resp_z.tolist(), ck.fail_u.tolist()]
        if self._jsonl:
            lines = (json.dumps(list(row)) for row in zip(*cols))
        else:
            # repr round-trips Python floats exactly -> bit-identical replay
            lines = (",".join(map(repr, row)) for row in zip(*cols))
        self._fh.write("\n".join(lines) + "\n")
        self.rows_written += ck.n

    def next_chunk(self) -> Optional[DeviceChunk]:
        ck = self.inner.next_chunk()
        if ck is None:
            self.close()
            return None
        if self._fh is not None:
            self._write(ck)
        return ck

    def close(self) -> None:
        if self._fh is None:
            return
        if self._drain_on_close:
            self._drain_on_close = False
            ck = self.inner.next_chunk()
            while ck is not None:
                self._write(ck)
                ck = self.inner.next_chunk()
        self._fh.close()
        self._fh = None

    def __enter__(self) -> "RecordingStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getstate__(self):
        raise TypeError(
            "RecordingStream holds an open trace file mid-write and cannot "
            "be snapshotted; record the trace in a plain run, then snapshot "
            "replay runs (TraceReplayStream pickles fine)")


def record_stream(inner: ChunkStream, path: str) -> RecordingStream:
    """Convenience alias: wrap ``inner`` so its chunks are dumped to ``path``."""
    return RecordingStream(inner, path)


# --------------------------------------------------------------------------- #
# Replay
# --------------------------------------------------------------------------- #

class TraceReplayStream:
    """Stream a trace file back as time-sorted :class:`DeviceChunk` s.

    ``chunk_rows`` bounds peak memory (rows are read lazily, one chunk's worth
    at a time).  ``fail_base`` / ``fail_slow_boost`` default to the header's
    values (falling back to the :class:`~repro_torch.sim.devices.PopulationConfig`
    defaults for headerless files); ``seed`` drives synthesized randomness for
    traces that omit the ``resp_z`` / ``fail_u`` columns."""

    def __init__(self, path: str, chunk_rows: int = 65536,
                 fail_base: Optional[float] = None,
                 fail_slow_boost: Optional[float] = None, seed: int = 0):
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        self.path = path
        self.chunk_rows = int(chunk_rows)
        self._jsonl = _is_jsonl(path)
        self._rng = np.random.default_rng(seed)
        self._fh: Optional[IO[str]] = open(path, "r")
        self._last_t = -math.inf
        self.rows_read = 0
        self.skipped_rows = 0           # malformed/truncated rows tolerated
        self._row_width: Optional[int] = None   # set by the first valid row
        header = self._read_header()
        self.fail_base = fail_base if fail_base is not None else \
            header.get("fail_base", PopulationConfig.fail_base)
        self.fail_slow_boost = fail_slow_boost if fail_slow_boost is not None \
            else header.get("fail_slow_boost", PopulationConfig.fail_slow_boost)

    # ------------------------------------------------------------------ header

    def _read_header(self) -> Dict[str, float]:
        assert self._fh is not None
        meta: Dict[str, float] = {}
        if self._jsonl:
            first = self._fh.readline()
            if not first:
                self._cols: List[str] = list(COLUMNS)
                return meta
            obj = json.loads(first)
            if isinstance(obj, dict) and obj.get("format") == FORMAT_NAME:
                self._cols = [_ALIASES.get(c, c) for c in
                              obj.get("columns", list(COLUMNS))]
                for k in ("fail_base", "fail_slow_boost"):
                    if k in obj:
                        meta[k] = float(obj[k])
            elif isinstance(obj, dict):
                # headerless JSONL of row *objects* ({"time": ..., ...}):
                # column order comes from the first row's keys
                self._row_keys = list(obj)
                self._cols = [_ALIASES.get(k.lower(), k.lower())
                              for k in self._row_keys]
                self._pending_row = [obj[k] for k in self._row_keys]
            elif isinstance(obj, list):
                # headerless JSONL of row arrays: positional columns
                self._cols = list(COLUMNS)[:len(obj)]
                self._pending_row = obj
            else:
                raise ValueError(
                    f"{self.path}: unsupported JSONL row {obj!r} (expected "
                    "a venn-trace header, an object, or an array)")
            return meta
        # CSV: comments, then a column-name header row
        pos = self._fh.tell()
        line = self._fh.readline()
        while line.startswith("#"):
            body = line[1:].strip()
            if "=" in body:
                k, _, v = body.partition("=")
                try:
                    meta[k.strip()] = float(v)
                except ValueError:
                    pass
            pos = self._fh.tell()
            line = self._fh.readline()
        names = [c.strip().lower() for c in line.strip().split(",")]
        if "time" in (_ALIASES.get(n, n) for n in names):
            self._cols = [_ALIASES.get(n, n) for n in names]
        else:
            # headerless CSV: positional columns; rewind to the data row
            self._cols = list(COLUMNS)
            self._fh.seek(pos)
        return meta

    _pending_row: Optional[list] = None
    _row_keys: Optional[List[str]] = None    # JSONL object rows: key order

    # ------------------------------------------------------------------- chunks

    def _parse_row(self, line: str) -> Optional[List[float]]:
        """One trace line -> row of floats, or None for a malformed /
        truncated / non-finite-time row (skipped + counted, never raised:
        a corrupt line in a gigabyte trace must not kill the replay)."""
        try:
            if self._jsonl:
                obj = json.loads(line)
                if self._row_keys is not None:
                    obj = [obj[k] for k in self._row_keys]
                row = [float(x) for x in obj]
            else:
                row = [float(x) for x in line.split(",")]
        except (ValueError, TypeError, KeyError, json.JSONDecodeError):
            self.skipped_rows += 1
            return None
        if self._row_width is None:
            self._row_width = len(row)
        elif len(row) != self._row_width:
            self.skipped_rows += 1      # truncated (or padded) row
            return None
        t_ix = self._time_ix
        if t_ix is not None and t_ix < len(row) \
                and not math.isfinite(row[t_ix]):
            self.skipped_rows += 1      # NaN/inf timestamp: unusable row
            return None
        return row

    @property
    def _time_ix(self) -> Optional[int]:
        try:
            return self._cols.index("time")
        except ValueError:
            return None

    def _parse_rows(self) -> List[List[float]]:
        assert self._fh is not None
        rows: List[List[float]] = []
        if self._pending_row is not None:
            pending, self._pending_row = self._pending_row, None
            try:
                row = [float(x) for x in pending]
            except (ValueError, TypeError):
                self.skipped_rows += 1
            else:
                self._row_width = len(row)
                rows.append(row)
        # readline loop (not `for line in fh`): file iteration disables
        # tell(), which the pickle path needs to snapshot the read offset
        readline = self._fh.readline
        while True:
            line = readline()
            if not line:
                break
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            row = self._parse_row(line)
            if row is None:
                continue
            rows.append(row)
            if len(rows) >= self.chunk_rows:
                break
        return rows

    def next_chunk(self) -> Optional[DeviceChunk]:
        if self._fh is None:
            return None
        rows = self._parse_rows()
        if not rows:
            self.close()
            return None
        mat = np.asarray(rows, dtype=np.float64)
        by_name = {}
        for j, name in enumerate(self._cols):
            if j < mat.shape[1]:
                by_name[name] = mat[:, j]
        if "time" not in by_name:
            raise ValueError(f"{self.path}: trace rows carry no time column")
        times = by_name["time"]
        if np.any(np.diff(times) < 0) or times[0] < self._last_t:
            raise ValueError(f"{self.path}: trace times are not sorted "
                             "(chunk streams must be time-ordered)")
        self._last_t = float(times[-1])
        n = len(times)
        self.rows_read += n

        def col(name: str) -> np.ndarray:
            arr = by_name.get(name)
            if arr is not None:
                return arr
            return np.full(n, _DEFAULTS[name])

        resp_z = by_name.get("resp_z")
        if resp_z is None:
            resp_z = self._rng.standard_normal(n)
        fail_u = by_name.get("fail_u")
        if fail_u is None:
            fail_u = self._rng.uniform(size=n)
        return DeviceChunk(times=times, cpu=col("cpu"), mem=col("mem"),
                           speed=col("speed"), resp_z=resp_z, fail_u=fail_u)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ------------------------------------------------------ crash snapshots

    def __getstate__(self):
        """Pickle as (state, read offset); the file handle is reopened and
        re-seeked on restore, so a snapshotted replay resumes on the exact
        next unread byte."""
        d = dict(self.__dict__)
        fh = d.pop("_fh")
        d["_fh_offset"] = fh.tell() if fh is not None else None
        return d

    def __setstate__(self, d):
        offset = d.pop("_fh_offset", None)
        self.__dict__.update(d)
        if offset is None:
            self._fh = None
        else:
            self._fh = open(self.path, "r")
            self._fh.seek(offset)

    def __enter__(self) -> "TraceReplayStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
