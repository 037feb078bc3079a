"""Device population & check-in process (Fig. 2, Fig. 8a).

The paper's traces (FedScale availability; AI-Benchmark capacities) are not
redistributable, so we generate synthetic populations calibrated to the same
qualitative structure:

* **diurnal availability** — non-homogeneous Poisson check-ins with a 24-h
  sinusoidal rate (Fig. 2a);
* **heterogeneous capacity** — log-normal CPU/memory marginals with positive
  correlation (Fig. 2b), stratified by thresholds into the paper's four
  regions: General ⊇ {Compute-Rich, Memory-Rich} ⊇ High-Performance, i.e.
  nested *and* overlapping eligible sets (Fig. 8a);
* **speed** correlated with capacity; response times log-normal (Wang 2023),
  slow devices more likely to fail (§4.3).

Each device executes at most one task per check-in (the paper limits one job
per device-day) and then leaves the pool.

Fast path: :meth:`DeviceGenerator.sample_chunk` emits whole check-in chunks as
struct-of-arrays (:class:`DeviceChunk`) — times, capabilities, speeds, plus
pre-sampled response-time and failure draws — so the simulator touches NumPy
arrays per check-in and materializes a :class:`~repro_torch.core.types.Device`
object only for granted devices.

Stream protocol: the simulator does not talk to generators directly — it
consumes any :class:`ChunkStream`, a pull source of time-sorted, non-
overlapping chunks.  :class:`GeneratorStream` adapts a
:class:`DeviceGenerator` (owning the span-bounding logic that used to live in
the simulator); the scenario engine supplies modulated and trace-replay
streams behind the same protocol.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Protocol, Tuple

import numpy as np

from ..core.types import Device, Requirement

DAY = 24 * 3600.0

# Device chunks span at most this much simulated time (smaller spans are used
# at high rates so a chunk's arrays stay within memory).
CHUNK_SECONDS = 6 * 3600.0

# The four requirement classes of Figure 8a.
REQ_GENERAL = Requirement.of("general", cpu=1.0, mem=1.0)
REQ_COMPUTE = Requirement.of("compute_rich", cpu=6.0, mem=1.0)
REQ_MEMORY = Requirement.of("memory_rich", cpu=1.0, mem=6.0)
REQ_HIGHPERF = Requirement.of("high_performance", cpu=6.0, mem=6.0)
REQUIREMENT_CLASSES: Tuple[Requirement, ...] = (
    REQ_GENERAL, REQ_COMPUTE, REQ_MEMORY, REQ_HIGHPERF,
)


def response_time_from(speed: float, z: float, task_time_mean: float,
                       sigma: float) -> float:
    """Log-normal response time from a pre-sampled standard normal ``z``.
    Single source of truth for the response-time model: used by both
    ``DeviceGenerator.response_time`` and the simulator's inlined grant
    path (on the chunk's pre-sampled draws)."""
    return task_time_mean / (speed if speed > 1e-3 else 1e-3) * math.exp(sigma * z)


def fails_from(speed: float, u: float, fail_base: float,
               fail_slow_boost: float) -> bool:
    """Failure draw from a pre-sampled uniform ``u`` (slow devices fail
    more, §4.3).  Shared by ``DeviceGenerator.fails`` and the simulator."""
    return u < fail_base + fail_slow_boost / (1.0 + speed)


@dataclass
class PopulationConfig:
    base_rate: float = 2.0          # mean device check-ins per second
    diurnal_amplitude: float = 0.6  # rate swing (Fig. 2a)
    diurnal_phase: float = 0.0
    cpu_med: float = 4.0            # log-normal medians / sigmas (Fig. 2b)
    cpu_sigma: float = 0.5
    mem_med: float = 4.0
    mem_sigma: float = 0.55
    cap_corr: float = 0.45          # cpu-mem correlation
    speed_exponent: float = 0.7     # speed ~ (cpu/cpu_med)^exp * noise
    speed_noise_sigma: float = 0.25
    fail_base: float = 0.05         # failure probability, higher for slow devs
    fail_slow_boost: float = 0.10
    seed: int = 0


@dataclass
class DeviceChunk:
    """Struct-of-arrays check-in chunk: one row per device, time-sorted.

    ``resp_z`` / ``fail_u`` are pre-sampled randomness (a standard normal for
    the log-normal response time, a uniform for the failure draw) so granting
    a device needs no RNG calls on the hot path.  ``atom_ids`` is filled in by
    the simulator once the scheduler classifies the chunk."""

    times: np.ndarray
    cpu: np.ndarray
    mem: np.ndarray
    speed: np.ndarray
    resp_z: np.ndarray
    fail_u: np.ndarray
    atom_ids: np.ndarray = None  # type: ignore[assignment]

    @property
    def n(self) -> int:
        return len(self.times)


class DeviceGenerator:
    """Vectorized generator of (time, Device) check-ins."""

    def __init__(self, cfg: PopulationConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    # --------------------------------------------------------------- rates

    def rate(self, t: float) -> float:
        c = self.cfg
        return c.base_rate * (1.0 + c.diurnal_amplitude *
                              math.sin(2 * math.pi * (t - c.diurnal_phase) / DAY))

    def rate_array(self, ts: np.ndarray) -> np.ndarray:
        c = self.cfg
        return c.base_rate * (1.0 + c.diurnal_amplitude *
                              np.sin(2 * np.pi * (ts - c.diurnal_phase) / DAY))

    def _max_rate(self) -> float:
        return self.cfg.base_rate * (1.0 + self.cfg.diurnal_amplitude)

    def _max_rate_window(self, t0: float, t1: float) -> float:
        """Upper rate bound over ``[t0, t1)`` for the thinning sampler.
        Subclasses with localized rate events (scenario spikes) tighten this
        so a short burst does not inflate candidate sampling everywhere."""
        return self._max_rate()

    # ------------------------------------------------------------- sampling

    def checkin_times(self, t0: float, t1: float) -> np.ndarray:
        """Thinning sampler for the non-homogeneous Poisson process."""
        lam = self._max_rate_window(t0, t1)
        n = self.rng.poisson(lam * (t1 - t0))
        ts = np.sort(self.rng.uniform(t0, t1, size=n))
        keep = self.rng.uniform(0, lam, size=n) < self.rate_array(ts)
        return ts[keep]

    def sample_devices(self, times: np.ndarray) -> List[Device]:
        c, n = self.cfg, len(times)
        z = self.rng.standard_normal((n, 2))
        z1 = z[:, 0]
        z2 = c.cap_corr * z[:, 0] + math.sqrt(1 - c.cap_corr ** 2) * z[:, 1]
        cpu = c.cpu_med * np.exp(c.cpu_sigma * z1)
        mem = c.mem_med * np.exp(c.mem_sigma * z2)
        speed = (cpu / c.cpu_med) ** c.speed_exponent * np.exp(
            c.speed_noise_sigma * self.rng.standard_normal(n))
        return [
            Device(caps={"cpu": float(cpu[i]), "mem": float(mem[i])},
                   speed=float(speed[i]), checkin_time=float(times[i]))
            for i in range(n)
        ]

    def sample_chunk(self, t0: float, t1: float) -> DeviceChunk:
        """Sample one struct-of-arrays check-in chunk for ``[t0, t1)``.

        Uses the same draws (in the same order) as ``checkin_times`` +
        ``sample_devices`` for the population arrays, then pre-samples the
        response-time normals and failure uniforms vectorized."""
        times = self.checkin_times(t0, t1)
        c, n = self.cfg, len(times)
        z = self.rng.standard_normal((n, 2))
        z1 = z[:, 0]
        z2 = c.cap_corr * z[:, 0] + math.sqrt(1 - c.cap_corr ** 2) * z[:, 1]
        cpu = c.cpu_med * np.exp(c.cpu_sigma * z1)
        mem = c.mem_med * np.exp(c.mem_sigma * z2)
        speed = (cpu / c.cpu_med) ** c.speed_exponent * np.exp(
            c.speed_noise_sigma * self.rng.standard_normal(n))
        resp_z = self.rng.standard_normal(n)
        fail_u = self.rng.uniform(size=n)
        return DeviceChunk(times=times, cpu=cpu, mem=mem, speed=speed,
                           resp_z=resp_z, fail_u=fail_u)

    def stream(self, horizon: float, chunk: float = 6 * 3600.0
               ) -> Iterator[Device]:
        t = 0.0
        while t < horizon:
            hi = min(t + chunk, horizon)
            for d in self.sample_devices(self.checkin_times(t, hi)):
                yield d
            t = hi

    # ----------------------------------------------------- task execution

    def response_time(self, device: Device, task_time_mean: float,
                      sigma: float) -> float:
        """Log-normal response time scaled by the device's speed."""
        return response_time_from(device.speed,
                                  float(self.rng.standard_normal()),
                                  task_time_mean, sigma)

    def fails(self, device: Device) -> bool:
        return fails_from(device.speed, float(self.rng.uniform()),
                          self.cfg.fail_base, self.cfg.fail_slow_boost)


# --------------------------------------------------------------------------- #
# Chunk streams (the simulator's device-source protocol)
# --------------------------------------------------------------------------- #

class ChunkStream(Protocol):
    """A pull source of time-sorted device check-in chunks.

    Contract: successive :meth:`next_chunk` calls yield non-empty
    :class:`DeviceChunk` s whose times are sorted within each chunk and
    non-decreasing across chunks; ``None`` means the stream is exhausted.
    ``fail_base`` / ``fail_slow_boost`` parameterize the failure model the
    simulator applies to each chunk's pre-sampled ``fail_u`` draws.
    """

    fail_base: float
    fail_slow_boost: float

    def next_chunk(self) -> Optional[DeviceChunk]: ...


class GeneratorStream:
    """Adapts a :class:`DeviceGenerator` to the :class:`ChunkStream` protocol.

    Owns the chunk-span policy: spans are bounded so high-rate populations
    stay within memory (~250k check-ins per chunk), and empty spans are
    skipped so idle stretches cost one ``sample_chunk`` each, not one chunk
    load in the simulator."""

    def __init__(self, gen: DeviceGenerator, horizon: float):
        self.gen = gen
        self.horizon = float(horizon)
        self.fail_base = gen.cfg.fail_base
        self.fail_slow_boost = gen.cfg.fail_slow_boost
        self._t0 = 0.0

    def next_chunk(self) -> Optional[DeviceChunk]:
        while self._t0 < self.horizon:
            t0 = self._t0
            # bound chunk size so high-rate stretches stay within memory,
            # using the rate bound over the *upcoming window* — a localized
            # spike shrinks spans near it, not across the whole horizon
            # (max(rate, eps) also keeps zero-traffic populations valid)
            lam = self.gen._max_rate_window(
                t0, min(t0 + CHUNK_SECONDS, self.horizon))
            span = min(CHUNK_SECONDS, max(600.0, 250_000.0 / max(lam, 1e-9)))
            t1 = min(t0 + span, self.horizon)
            self._t0 = t1
            ck = self.gen.sample_chunk(t0, t1)
            if ck.n:
                return ck
        return None

