"""Compile declarative scenario specs into device chunk streams and job lists.

:class:`ModulatedGenerator` extends the synthetic
:class:`~repro_torch.sim.devices.DeviceGenerator` with the scenario engine's
modulation axes — multi-timezone diurnal mixtures, rate-spike windows,
correlated failure storms, capacity drift and straggler tails — all applied
vectorized on whole chunks, so scenario streams run at the same struct-of-
arrays speed as the plain generator.  Everything stays behind the
:class:`~repro_torch.sim.devices.ChunkStream` protocol; the simulator cannot tell a
scenario from a plain population (and the trace recorder can capture either).
"""
from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import Job
from ..sim.devices import (DAY, ChunkStream, DeviceChunk, DeviceGenerator,
                           GeneratorStream, PopulationConfig,
                           REQUIREMENT_CLASSES)
from ..sim.traces import generate_jobs
from .spec import ScenarioSpec

REQUIREMENT_BY_NAME = {r.name: r for r in REQUIREMENT_CLASSES}


class ModulatedGenerator(DeviceGenerator):
    """A :class:`DeviceGenerator` with scenario modulation layered on top.

    Window times are absolute seconds here (the spec's horizon fractions are
    resolved by :func:`build_stream`).  The rate envelope feeds the same
    thinning sampler as the base generator; per-device effects post-process
    the sampled chunk in place with draws from the generator's own RNG, so a
    (population seed, horizon) pair fully determines the stream.
    """

    def __init__(self, cfg: PopulationConfig,
                 phases: Sequence[float] = (),
                 spikes: Sequence[Tuple[float, float, float]] = (),
                 storms: Sequence[Tuple[float, float, float]] = (),
                 drift: Optional[Tuple[float, float, float, float]] = None,
                 tail: Optional[Tuple[float, float]] = None):
        super().__init__(cfg)
        self._phases = tuple(phases)
        self._spikes = tuple(spikes)         # (t0, t1, multiplier)
        self._storms = tuple(storms)         # (t0, t1, fail_prob)
        self._drift = drift                  # (t0, t1, cpu_factor, mem_factor)
        self._tail = tail                    # (fraction, slow_factor)

    # ------------------------------------------------------------- rate envelope

    def rate_array(self, ts: np.ndarray) -> np.ndarray:
        c = self.cfg
        if self._phases:
            # timezone mixture: mean of phase-shifted sinusoids — peaks flatten
            # and shift as regions wake up at different UTC hours
            mod = np.mean([np.sin(2 * np.pi * (ts - p) / DAY)
                           for p in self._phases], axis=0)
            r = c.base_rate * (1.0 + c.diurnal_amplitude * mod)
        else:
            r = super().rate_array(ts)
        for t0, t1, mult in self._spikes:
            r = np.where((ts >= t0) & (ts < t1), r * mult, r)
        return r

    def rate(self, t: float) -> float:
        return float(self.rate_array(np.asarray([t]))[0])

    def _max_rate(self) -> float:
        # overlapping spike windows stack multiplicatively in rate_array, so
        # the global bound must be the product, not the max
        m = super()._max_rate()
        for _, _, mult in self._spikes:
            m *= mult
        return m

    def _max_rate_window(self, t0: float, t1: float) -> float:
        # only spikes overlapping [t0, t1) raise the thinning bound — a short
        # 12x flash crowd must not 12x the candidate sampling (and rejection)
        # across the whole horizon.  Overlapping spikes multiply (matching
        # rate_array), keeping the bound >= the true rate everywhere.
        # (super()._max_rate() is the spike-free diurnal bound, which also
        # dominates the phase-mixture envelope.)
        m = super()._max_rate()
        for s0, s1, mult in self._spikes:
            if s0 < t1 and t0 < s1:
                m *= mult
        return m

    # ------------------------------------------------------------- chunk effects

    def _drift_factors(self, ts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        t0, t1, fc, fm = self._drift
        frac = np.clip((ts - t0) / max(t1 - t0, 1e-9), 0.0, 1.0)
        return 1.0 + frac * (fc - 1.0), 1.0 + frac * (fm - 1.0)

    def sample_chunk(self, t0: float, t1: float) -> DeviceChunk:
        ck = super().sample_chunk(t0, t1)
        if ck.n == 0:
            return ck
        if self._drift is not None:
            fc, fm = self._drift_factors(ck.times)
            ck.cpu *= fc
            ck.mem *= fm
            # speed tracks cpu capability with the population's exponent, so
            # an upgraded fleet is faster, not just roomier
            ck.speed *= fc ** self.cfg.speed_exponent
        if self._tail is not None:
            fraction, factor = self._tail
            slow = self.rng.uniform(size=ck.n) < fraction
            ck.speed[slow] *= factor
        for s0, s1, p in self._storms:
            inside = (ck.times >= s0) & (ck.times < s1)
            if inside.any():
                # force failures by clamping the pre-sampled uniform below any
                # positive threshold; recorded traces capture the clamped
                # draws, so replays reproduce the storm exactly
                forced = inside & (self.rng.uniform(size=ck.n) < p)
                ck.fail_u[forced] = -1.0
        return ck


# --------------------------------------------------------------------------- #
# Spec compilation
# --------------------------------------------------------------------------- #

def build_stream(spec: ScenarioSpec, seed: int, horizon: Optional[float] = None,
                 population: Optional[PopulationConfig] = None) -> ChunkStream:
    """Compile ``spec``'s device side into a chunk stream.

    ``seed`` offsets the population seed so multi-seed runs draw independent
    device processes; ``horizon``/``population`` override the spec's (the
    runner passes fast-scaled ones).
    """
    horizon = float(horizon if horizon is not None else spec.sim.max_time)
    pop = population if population is not None else spec.population
    cfg = replace(pop, seed=pop.seed + 7919 * seed)
    gen = ModulatedGenerator(
        cfg,
        phases=spec.diurnal_phases,
        spikes=[(s.start * horizon, s.stop * horizon, s.multiplier)
                for s in spec.rate_spikes],
        storms=[(s.start * horizon, s.stop * horizon, s.fail_prob)
                for s in spec.failure_storms],
        drift=None if spec.capacity_drift is None else (
            spec.capacity_drift.start * horizon,
            spec.capacity_drift.stop * horizon,
            spec.capacity_drift.cpu_factor,
            spec.capacity_drift.mem_factor),
        tail=None if spec.speed_tail is None else (
            spec.speed_tail.fraction, spec.speed_tail.factor),
    )
    return GeneratorStream(gen, horizon)


def build_jobs(spec: ScenarioSpec, seed: int,
               jobs_cfg=None) -> List[Job]:
    """Compile ``spec``'s job side: base trace + pinning + tenant tiers."""
    cfg = jobs_cfg if jobs_cfg is not None else spec.jobs
    cfg = replace(cfg, seed=cfg.seed + 104729 * seed)
    jobs = generate_jobs(cfg)
    if spec.pin_requirement is not None:
        req = REQUIREMENT_BY_NAME[spec.pin_requirement]
        for j in jobs:
            j.requirement = req
    if spec.tenant_tiers:
        # deterministic tier assignment: shuffle job indices with a seeded
        # RNG, then slice by cumulative fraction
        rng = np.random.default_rng(cfg.seed + 1)
        order = rng.permutation(len(jobs))
        edges = np.cumsum([t.fraction for t in spec.tenant_tiers])
        bounds = np.rint(edges * len(jobs)).astype(int)
        lo = 0
        for tier, hi in zip(spec.tenant_tiers, bounds):
            for i in order[lo:hi]:
                jobs[i].tenant = tier.name
                jobs[i].priority = tier.priority
            lo = hi
        for i in order[lo:]:                 # rounding remainder -> last tier
            jobs[i].tenant = spec.tenant_tiers[-1].name
            jobs[i].priority = spec.tenant_tiers[-1].priority
    return jobs
