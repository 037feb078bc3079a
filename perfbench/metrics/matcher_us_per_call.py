"""The matcher (``accel/engine.py::match_chunk_torch``, one C call and one
``match_segment`` launch a call): the engine's ``matcher_s`` over its
``matcher_calls``, in us, over the traced window."""


def read(r):
    if not r["matcher_calls"]:
        return None
    return r["matcher_s"] / r["matcher_calls"] * 1e6
