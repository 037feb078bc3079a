"""The flash-attention wrapper's route table and launch counters.

On a card the wrapper launches one of two CUDA kernels, chosen by
``flash_route(dtype, head_dim)``: the tensor-core kernel (``"wgmma"``, bf16)
or the FMA kernel (``"fma"``, f32), both at every head_dim of
``HEAD_DIMS``.  These tests hold the table against its statement,
its refusals, the per-route counters (through ``launch`` with a stand-in
library: no kernel runs on the CPU) and the refusal of query rows without a
key on both routes' inputs.  The kernels themselves are held against the
plain version on the card by ``chip_smoke.py``.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.accel.kernels import build
from repro_torch.kernels import flash_attention as fm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype,head_dim",
                         itertools.product(_DTYPES, fm.HEAD_DIMS))
def test_flash_route_table(dtype, head_dim):
    want = "wgmma" if dtype == "bfloat16" else "fma"
    assert fm.flash_route(_DTYPES[dtype], head_dim) == want


@pytest.mark.parametrize("dtype,head_dim,match", [
    (torch.float16, 64, "dtype"),
    (torch.float64, 128, "dtype"),
    (torch.bfloat16, 96, "head_dim"),
    (torch.float32, 256, "head_dim"),
    (torch.bfloat16, 0, "head_dim"),
])
def test_flash_route_refuses_what_no_kernel_takes(dtype, head_dim, match):
    with pytest.raises(ValueError, match=match):
        fm.flash_route(dtype, head_dim)


class _Entry:
    """Stands in for a kernel's C entry: records its arguments, returns a
    fixed launch code."""

    def __init__(self, code=0):
        self.argtypes = None
        self.restype = None
        self.code = code
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _Lib:
    def __init__(self, code=0):
        self.venn_flash_attention = _Entry(code)
        self.venn_flash_attention_wgmma = _Entry(code)


def _stand_in(monkeypatch, code=0):
    libs = {"flash_attention": _Lib(code), "flash_attention_wgmma": _Lib(code)}
    monkeypatch.setattr(build, "load_library", lambda name: libs[name])
    fm.reset_launches()
    return (libs["flash_attention"].venn_flash_attention,
            libs["flash_attention_wgmma"].venn_flash_attention_wgmma)


def _qkv(dtype, D, B=1, T=8, S=8, H=4, Hkv=2):
    return (torch.zeros((B, T, H, D), dtype=dtype),
            torch.zeros((B, S, Hkv, D), dtype=dtype),
            torch.zeros((B, S, Hkv, D), dtype=dtype))


@pytest.mark.parametrize("routes", [("wgmma",), ("fma",),
                                    ("wgmma", "fma", "wgmma"),
                                    ("fma", "fma", "wgmma", "fma")])
def test_per_route_counters_sum_to_launches(monkeypatch, routes):
    fma, wgmma = _stand_in(monkeypatch)
    for route in routes:
        dtype = torch.bfloat16 if route == "wgmma" else torch.float32
        q, k, v = _qkv(dtype, 64)
        fm.launch(route, q, k, v, torch.empty_like(q), causal=True,
                  window=0, q_offset=0, stream=0)
    assert fm.launches_wgmma == routes.count("wgmma") == len(wgmma.calls)
    assert fm.launches_fma == routes.count("fma") == len(fma.calls)
    assert fm.launches == fm.launches_wgmma + fm.launches_fma == len(routes)
    fm.reset_launches()
    assert fm.launches == fm.launches_wgmma == fm.launches_fma == 0


def test_launch_passes_the_call_to_its_route(monkeypatch):
    fma, wgmma = _stand_in(monkeypatch)
    q, k, v = _qkv(torch.bfloat16, 128, B=2, T=5, S=7, H=6, Hkv=3)
    out = torch.empty_like(q)
    fm.launch("wgmma", q, k, v, out, causal=False, window=3, q_offset=2,
              stream=11)
    (args,) = wgmma.calls
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    assert args[4:13] == (2, 5, 7, 6, 3, 128, 0, 3, 2)
    assert args[13] == pytest.approx(1 / np.sqrt(128))
    assert args[14] == 11 and len(args) == 15
    assert len(wgmma.argtypes) == 15
    fm.launch("fma", q, k, v, out, causal=True, window=0, q_offset=0,
              stream=11)
    (args,) = fma.calls
    assert args[14:] == (1, 11)      # the bf16 flag, then the stream
    assert len(fma.argtypes) == 16


@pytest.mark.parametrize("route", ["wgmma", "fma"])
def test_a_refused_launch_raises_and_counts(monkeypatch, route):
    _stand_in(monkeypatch, code=-2)
    q, k, v = _qkv(torch.bfloat16, 64)
    with pytest.raises(build.KernelLaunchError, match=route):
        fm.launch(route, q, k, v, torch.empty_like(q), causal=True,
                  window=0, q_offset=0, stream=0)
    assert fm.launches == 1


@pytest.mark.parametrize("dtype,head_dim", [(torch.bfloat16, 64),
                                            (torch.bfloat16, 128),
                                            (torch.float32, 64),
                                            (torch.float32, 80)])
@pytest.mark.parametrize("T,S,causal,window,q_offset", [
    (8, 4, False, 8, 100),        # the window ends before the keys start
    (8, 8, True, 0, -1),          # a negative offset: row 0 sees no key
])
def test_rows_without_a_key_are_refused_on_both_routes(dtype, head_dim, T, S,
                                                       causal, window,
                                                       q_offset):
    fm.flash_route(dtype, head_dim)            # a route exists for the inputs
    q, k, v = _qkv(dtype, head_dim, T=T, S=S)
    with pytest.raises(ValueError, match="no valid key"):
        fm.flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


@pytest.mark.parametrize("dtype,head_dim", [(torch.bfloat16, 64),
                                            (torch.float32, 32)])
def test_the_cpu_runs_the_plain_version_and_launches_nothing(dtype,
                                                             head_dim):
    fm.reset_launches()
    rng = np.random.default_rng(head_dim)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(dtype) for sh in ((1, 40, 4, head_dim),
                                     (1, 40, 2, head_dim),
                                     (1, 40, 2, head_dim)))
    got = fm.flash_attention(q, k, v, causal=True)
    want = fm.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(got, want)
    assert fm.launches == fm.launches_wgmma == fm.launches_fma == 0
