"""The device: the share of the traced window in which no kernel, copy or
set ran on the card (``torch.profiler``'s device trace, intervals merged),
in %, in a closed-loop cell."""


def read(r):
    d = r["device"]
    if d["window_s"] <= 0:
        return None
    return (1.0 - d["busy_s"] / d["window_s"]) * 100.0
