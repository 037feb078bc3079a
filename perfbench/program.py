"""The one place the harness touches the program (the ``repro_torch`` port).

The benchmark makes its own jobs and check-in stream (``perfbench/gen``)
and hands them to the port as the port's own input types: ``Job`` objects,
and ``DeviceChunk`` objects through the port's ``ChunkStream`` protocol.
Everything the port derives from them (atom ids, plans, grants) is its own.
Each episode gets new ``Job`` and ``DeviceChunk`` objects over the same
arrays, ``atom_ids`` unset, so no chunk arrives already classified.
"""
from __future__ import annotations


def port():
    """The port's modules, imported when a run starts (not at import)."""
    from repro_torch.core import SCHEDULERS
    from repro_torch.core.types import Job, Requirement
    from repro_torch.sim.devices import DeviceChunk
    from repro_torch.sim.simulator import SimConfig, Simulator
    return {"SCHEDULERS": SCHEDULERS, "Job": Job, "Requirement": Requirement,
            "DeviceChunk": DeviceChunk, "SimConfig": SimConfig,
            "Simulator": Simulator}


class Stream:
    """The benchmark's stream as the port's ``ChunkStream``: chunk after
    chunk of the pre-made arrays, each in a new ``DeviceChunk``.  Keeps
    each chunk it handed out with its row offset: the port writes its atom
    ids into them, which the check reads."""

    def __init__(self, stream, chunk_cls):
        self.src = stream
        self.cls = chunk_cls
        self.fail_base = stream.fail_base
        self.fail_slow_boost = stream.fail_slow_boost
        self.i = 0
        self.handed = []

    def next_chunk(self):
        if self.i >= self.src.num_chunks():
            return None
        ck = self.cls(**self.src.chunk(self.i))
        self.handed.append((int(self.src.bounds[self.i]), ck))
        self.i += 1
        return ck


class Episode:
    """One new simulator of the port over the benchmark's inputs: VENN on
    the array drain, on ``device``."""

    def __init__(self, mods, cfg: dict, trace: dict, stream, seed: int,
                 horizon: float, device):
        reqs = [mods["Requirement"].of(r["name"], cpu=r["cpu"], mem=r["mem"])
                for r in cfg["requirements"]]
        Job = mods["Job"]
        req_ix = trace["requirement"].tolist()
        demand = trace["demand"].tolist()
        rounds = trace["rounds"].tolist()
        arrival = trace["arrival"].tolist()
        mean = trace["task_mean"].tolist()
        deadline = trace["deadline"].tolist()
        jobs = [Job(job_id=i, requirement=reqs[req_ix[i]],
                    demand_per_round=demand[i], total_rounds=rounds[i],
                    arrival_time=arrival[i], task_time_mean=mean[i],
                    task_time_sigma=trace["task_sigma"],
                    quorum_fraction=trace["quorum"], deadline=deadline[i])
                for i in range(len(demand))]
        s = cfg["scheduler"]
        self.sched = mods["SCHEDULERS"]["venn"](
            seed=seed, num_tiers=s["num_tiers"], epsilon=s["epsilon"],
            supply_window=s["supply_window_s"], device=device)
        self.stream = Stream(stream, mods["DeviceChunk"])
        self.sim = mods["Simulator"](
            jobs, self.sched,
            cfg=mods["SimConfig"](max_time=horizon,
                                  max_round_retries=cfg["sim"]
                                  ["max_round_retries"]),
            stream=self.stream, engine="array", record_grants=True,
            device=device)
        self.until = 0.0

    def step_until(self, t: float) -> bool:
        self.until = t
        return self.sim.step_until(t)

    @property
    def decided(self) -> int:
        """Check-ins the port has decided: examined, skipped or refused."""
        return self.sim.checkins_seen + self.sim.checkins_skipped

    def answers(self) -> dict:
        """What the check compares, taken once the window has closed."""
        sim = self.sim
        until = min(self.until, sim.cfg.max_time)
        if all(j.completion_time is not None for j in sim.jobs):
            until = min(until, sim.now)     # finished: nothing decided later
        return {
            "until": until,
            "grants": list(sim.grant_log),
            "rounds": [(r.job_id, r.round_index, r.submit, r.alloc_complete,
                        r.complete, r.demand, r.responses, r.failures,
                        r.retries) for r in sim.metrics.rounds],
            "loaded": [(off, ck.atom_ids) for off, ck in self.stream.handed
                       if ck.atom_ids is not None],
            "atom_keys": self.sched.index.interner.keys(),
        }


def counters(episodes) -> dict:
    """The program's own stopwatches and counts, summed over episodes:
    check-ins decided, the simulator's drain and stream wall seconds (its
    ``sim.drain_wall_s`` / ``sim.stream_wall_s``), the matcher's calls and
    seconds and the mirror's rebuild and patch seconds (the engine's)."""
    c = {"decided": 0, "drain_s": 0.0, "stream_s": 0.0, "matcher_s": 0.0,
         "matcher_calls": 0, "rebuild_s": 0.0, "patch_s": 0.0}
    for ep in episodes:
        sim, eng = ep.sim, ep.sim.engine
        c["decided"] += ep.decided
        c["drain_s"] += sim.drain_seconds
        c["stream_s"] += sim.stream_seconds
        c["matcher_s"] += eng.matcher_s
        c["matcher_calls"] += eng.matcher_calls
        c["rebuild_s"] += eng.rebuild_s
        c["patch_s"] += eng.patch_s
    return c
