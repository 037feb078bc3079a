"""Drain routing (``sim/simulator.py::_drain_array``): the rows the drain
handed to the matcher route (``engine.match``, the ``rows`` of each
``accel.match`` span) as a share of the check-ins decided in the traced
window, in %.  The rest went by the scalar route, a head miss or an idle
skip.  Rows cut off a segment's end by a control event its grants armed
are handed over again and counted again."""


def read(r):
    if not r["decided"]:
        return None
    return r["matcher_route_rows"] / r["decided"] * 100.0
