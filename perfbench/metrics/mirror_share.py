"""The mirror (``accel/state.py``): the engine's full-rebuild and patch
seconds as a share of the traced window's wall time, in %."""


def read(r):
    return (r["rebuild_s"] + r["patch_s"]) / r["window_s"] * 100.0
