"""Kernel ``match_segment``: the least time a launch could take
(``perfbench/roofline/match_segment.py``, from each launch's shapes) over
the device time a launch took (``torch.profiler``), means over the traced
window, in %."""
from roofline import match_segment


def read(r):
    shapes = r["shapes"]["match_segment"]
    runs = [v for k, v in r["device"]["kernels"].items()
            if "match_segment" in k]
    count = sum(c for c, _ in runs)
    if not shapes or not count:
        return None
    bound = sum(match_segment.least_seconds_of(*s) for s in shapes)
    device_s = sum(s for _, s in runs)
    return (bound / len(shapes)) / (device_s / count) * 100.0
