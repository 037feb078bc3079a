"""The replan (``core/manager.py``, ``accel/replan.py``): the program's
``venn.replan`` spans (category ``sched``), their mean duration in us, over
the traced window of a closed-loop cell."""


def read(r):
    if not r["replans"]:
        return None
    return r["replan_s"] / r["replans"] * 1e6
