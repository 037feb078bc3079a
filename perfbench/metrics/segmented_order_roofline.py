"""Kernel ``segmented_order`` (the replan's resort, ``segmented_rank.cu``'s
order entry): the least time a launch could take
(``perfbench/roofline/segmented_order.py``, one segment of the group's
jobs) over the device time a launch took (``torch.profiler``), means over
the traced window, in %."""
from roofline import segmented_order

KERNEL = "segmented_rank_kernel<true>"


def read(r):
    shapes = r["shapes"]["segmented_order"]
    runs = [v for k, v in r["device"]["kernels"].items() if KERNEL in k]
    count = sum(c for c, _ in runs)
    if not shapes or not count:
        return None
    bound = sum(segmented_order.least_seconds_of(n) for n in shapes)
    device_s = sum(s for _, s in runs)
    return (bound / len(shapes)) / (device_s / count) * 100.0
