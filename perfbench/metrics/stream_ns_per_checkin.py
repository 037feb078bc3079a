"""Stream and classification (``sim/simulator.py::_load_next_chunk``,
``core/eligibility.py``): the simulator's stream wall seconds (its
``sim.stream_wall_s``) a check-in decided, in ns, over the traced window."""


def read(r):
    if not r["decided"]:
        return None
    return r["stream_s"] / r["decided"] * 1e9
