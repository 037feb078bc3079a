"""The drain loop and grants (``sim/simulator.py::_drain_array``,
``_grant``): the drain's wall seconds less its stream, matcher, mirror and
replan seconds, a check-in decided, in ns, over the traced window."""


def read(r):
    if not r["decided"]:
        return None
    own = r["drain_s"] - r["stream_s"] - r["matcher_s"] - r["rebuild_s"] \
        - r["patch_s"] - r["replan_s"]
    return own / r["decided"] * 1e9
