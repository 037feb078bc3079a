"""Staging buffers for the scheduler kernels' small per-call transfers.

A matcher call or a replan resort moves a few hundred bytes each way.  From
pageable memory every such copy is a blocking staging copy of its own; here
the inputs of a call are laid out back to back in one pinned host buffer,
and a kernel's C entry makes the whole call itself from the raw pointers:
one non-blocking copy up, the launch, one non-blocking copy down into
another pinned buffer, one synchronise of the stream.  The buffers grow
geometrically and are reused call after call: that is safe because every
call ends with that synchronise, after which no copy that reads or writes
them is in flight.

One stage serves a device (:func:`stage_for`).  It holds no stream: each
call runs on the stream current at call time, as the mirror patches and
chunk uploads that the kernels read are enqueued there.  On
``device="cpu"`` the same buffers are plain host tensors and the wrappers
make the copies with torch, so the CPU tests run the staging code as the
card does.
"""
from __future__ import annotations

from typing import Dict

import torch


def _size(nbytes: int) -> int:
    return max(4096, 1 << (max(nbytes, 1) - 1).bit_length())


class PinnedStage:
    """A pinned upload buffer (``host_in``) and its device twin
    (``dev_in``); a device output buffer (``dev_out``) and its pinned twin
    (``host_out``); a device scratch buffer.  ``*_ptr`` are their
    addresses, ``*_np`` NumPy views of the host buffers."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self._index = self.device.index \
            if self.device.index is not None else 0
        self._scratch = None
        self._grow_in(0)
        self._grow_out(0)

    def _host(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.on_card)

    def _dev(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, device=self.device)

    def _grow_in(self, nbytes: int) -> None:
        size = _size(nbytes)
        self.host_in, self.dev_in = self._host(size), self._dev(size)
        self.host_in_np = self.host_in.numpy()
        self.host_in_ptr = self.host_in.data_ptr()
        self.dev_in_ptr = self.dev_in.data_ptr()

    def _grow_out(self, nbytes: int) -> None:
        size = _size(nbytes)
        self.dev_out, self.host_out = self._dev(size), self._host(size)
        self.host_out_np = self.host_out.numpy()
        self.dev_out_ptr = self.dev_out.data_ptr()
        self.host_out_ptr = self.host_out.data_ptr()

    def reserve(self, in_bytes: int, out_bytes: int) -> None:
        """Make room for ``in_bytes`` up and ``out_bytes`` down."""
        if in_bytes > self.host_in.numel():
            self._grow_in(in_bytes)
        if out_bytes > self.dev_out.numel():
            self._grow_out(out_bytes)

    def scratch(self, nbytes: int) -> torch.Tensor:
        """Device scratch of at least ``nbytes``, valid until the next call."""
        if self._scratch is None or self._scratch.numel() < nbytes:
            self._scratch = self._dev(_size(nbytes))
        return self._scratch

    def stream_handle(self) -> int:
        """The raw handle of the stream current on this device now (0 on
        the CPU), for a kernel's C entry.  The same value as
        ``torch.cuda.current_stream(device).cuda_stream`` without making a
        ``Stream`` object, which costs several µs a call (``chip_smoke.py``'s
        matcher phase times both and checks that they agree, on a side
        stream too)."""
        if not self.on_card:
            return 0
        return torch._C._cuda_getCurrentRawStream(self._index)


_stages: Dict[torch.device, PinnedStage] = {}


def stage_for(device) -> PinnedStage:
    """The stage of ``device`` (made at first use, kept for the process)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    st = _stages.get(dev)
    if st is None:
        st = _stages[dev] = PinnedStage(dev)
    return st
