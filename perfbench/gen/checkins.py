"""The benchmark's check-in sampler: a frozen copy, as arrays.

It draws, chunk for chunk and call for call, what the program's
``sim/devices.py::DeviceGenerator.sample_chunk`` draws under the chunk-span
policy of ``GeneratorStream`` (spans of at least 600 simulated seconds and
at most 6 hours, about 250 000 check-ins at the peak rate), so that one seed
gives the same stream in both.  The whole stream is made in set-up and kept
as one set of arrays with the chunk boundaries beside it; the harness hands
each chunk to the program as the program's own chunk type.

Parameters (a configuration's ``"population"`` object): ``base_rate``
(check-ins/s), ``diurnal_amplitude``, ``diurnal_phase``, ``cpu_med``,
``cpu_sigma``, ``mem_med``, ``mem_sigma``, ``cap_corr``, ``speed_exponent``,
``speed_noise_sigma``, ``fail_base``, ``fail_slow_boost``.
"""
from __future__ import annotations

import math

import numpy as np

DAY = 24 * 3600.0
CHUNK_SECONDS = 6 * 3600.0
FIELDS = ("times", "cpu", "mem", "speed", "resp_z", "fail_u")


def _rate(p, ts):
    return p["base_rate"] * (1.0 + p["diurnal_amplitude"] * np.sin(
        2 * np.pi * (ts - p["diurnal_phase"]) / DAY))


def _chunk(rng, p, t0, t1):
    lam = p["base_rate"] * (1.0 + p["diurnal_amplitude"])
    n = rng.poisson(lam * (t1 - t0))
    ts = np.sort(rng.uniform(t0, t1, size=n))
    times = ts[rng.uniform(0, lam, size=n) < _rate(p, ts)]
    n = len(times)
    z = rng.standard_normal((n, 2))
    z2 = p["cap_corr"] * z[:, 0] + math.sqrt(1 - p["cap_corr"] ** 2) * z[:, 1]
    cpu = p["cpu_med"] * np.exp(p["cpu_sigma"] * z[:, 0])
    mem = p["mem_med"] * np.exp(p["mem_sigma"] * z2)
    speed = (cpu / p["cpu_med"]) ** p["speed_exponent"] * np.exp(
        p["speed_noise_sigma"] * rng.standard_normal(n))
    resp_z = rng.standard_normal(n)
    fail_u = rng.uniform(size=n)
    return times, cpu, mem, speed, resp_z, fail_u


class Stream:
    """A whole check-in stream: ``arrays[f]`` for each of :data:`FIELDS`,
    and ``bounds``, the row offsets of the chunks (``len(chunks) + 1``)."""

    def __init__(self, arrays: dict, bounds: np.ndarray, p: dict):
        self.arrays = arrays
        self.bounds = bounds
        self.fail_base = float(p["fail_base"])
        self.fail_slow_boost = float(p["fail_slow_boost"])

    @property
    def n(self) -> int:
        return len(self.arrays["times"])

    def chunk(self, i: int) -> dict:
        lo, hi = int(self.bounds[i]), int(self.bounds[i + 1])
        return {f: self.arrays[f][lo:hi] for f in FIELDS}

    def num_chunks(self) -> int:
        return len(self.bounds) - 1


def generate(p: dict, seed: int, horizon: float) -> Stream:
    """The stream of ``[0, horizon)`` simulated seconds for ``seed``."""
    rng = np.random.default_rng(seed)
    lam = p["base_rate"] * (1.0 + p["diurnal_amplitude"])
    span = min(CHUNK_SECONDS, max(600.0, 250_000.0 / max(lam, 1e-9)))
    parts = {f: [] for f in FIELDS}
    bounds = [0]
    t0 = 0.0
    while t0 < horizon:
        t1 = min(t0 + span, horizon)
        cols = _chunk(rng, p, t0, t1)
        t0 = t1
        if len(cols[0]) == 0:
            continue
        for f, a in zip(FIELDS, cols):
            parts[f].append(a)
        bounds.append(bounds[-1] + len(cols[0]))
    arrays = {f: (np.concatenate(parts[f]) if parts[f] else np.zeros(0))
              for f in FIELDS}
    return Stream(arrays, np.asarray(bounds, dtype=np.int64), p)
