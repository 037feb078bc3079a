"""Kernel micro-benchmarks: each hand-written kernel (through
``repro_torch.kernels.ops``) and its plain version (``kernels/ref.py``, the
functions the reference's bench times as its jnp oracles) at the
reference's shapes, with the derived bytes moved or operations done.

Rows named ``*_ref_*`` time the plain version (the reference's row names);
``*_kernel_*`` rows time the kernel and carry its largest difference from
the plain version on the same inputs.  On the CPU a wrapper would run the
plain version again, so there are plain rows only.  On the card times come
from CUDA events over back-to-back calls after a warm-up."""
import time

import numpy as np
import torch

from .common import cli, emit
from ..device import resolve_device
from ..kernels import ops, ref


def _time(f, *args, reps=3):
    """Microseconds a call."""
    f(*args)
    if args[0].device.type == "cuda":
        torch.cuda.synchronize()
        reps = 20
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            f(*args)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        f(*args)
    return (time.perf_counter() - t0) / reps * 1e6


def _size(n, unit, suffix):
    return f"{n // unit}{suffix}" if n % unit == 0 else str(n)


def _err(a, b):
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def main(device=None, K=32, N=4 << 20, NQ=8 << 20, T=1024, H=8, HKV=2,
         D=64):
    dev = resolve_device(device)
    kernels = dev.type == "cuda"
    rng = np.random.default_rng(0)
    out = {}
    # fedavg: K=32 clients, 4M params
    u = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    u = u.to(dev)
    w = torch.ones((K,), dtype=torch.float32, device=dev)
    nbytes = K * N * 4 + N * 4
    gb = nbytes / 1e9
    tag = f"{K}x{_size(N, 1 << 20, 'M')}"
    us = _time(ref.fedavg_reduce_ref, u, w)
    emit(f"fedavg_ref_{tag}", us, f"GBps={gb/(us/1e6):.1f}")
    out["fedavg_reduce"] = {"plain_us": us, "bytes": nbytes}
    if kernels:
        err = _err(ops.fedavg_reduce(u, w), ref.fedavg_reduce_ref(u, w))
        us = _time(ops.fedavg_reduce, u, w)
        emit(f"fedavg_kernel_{tag}", us,
             f"GBps={gb/(us/1e6):.1f} max_abs_err={err:g}")
        out["fedavg_reduce"].update(kernel_us=us, max_abs_err=err)
    del u
    # quantize 8M floats
    x = torch.from_numpy(rng.standard_normal(NQ).astype(np.float32)).to(dev)
    nbytes = NQ * 5
    gb = nbytes / 1e9
    tag = _size(NQ, 1 << 20, "M")
    us = _time(ref.quantize_ref, x, 256)
    emit(f"quantize_ref_{tag}", us, f"GBps={gb/(us/1e6):.1f}")
    out["quantize"] = {"plain_us": us, "bytes": nbytes}
    if kernels:
        (qk, sk), (qp, sp) = ops.quantize(x, block=256), ref.quantize_ref(x)
        err = max(_err(qk, qp), _err(sk, sp))
        us = _time(lambda v: ops.quantize(v, block=256), x)
        emit(f"quantize_kernel_{tag}", us,
             f"GBps={gb/(us/1e6):.1f} max_abs_err={err:g}")
        out["quantize"].update(kernel_us=us, max_abs_err=err)
    del x
    # flash ref attention 1x1024x8x64
    qq = torch.from_numpy(rng.standard_normal((1, T, H, D))).to(
        dev, torch.bfloat16)
    kk = torch.from_numpy(rng.standard_normal((1, T, HKV, D))).to(
        dev, torch.bfloat16)
    flops = 4 * T * T * H * D
    tag = _size(T, 1024, "k")

    def plain(a, b):
        return ref.flash_attention_ref(a, b, b, causal=True)

    us = _time(plain, qq, kk)
    emit(f"attention_ref_{tag}", us, f"GFLOPs={flops/1e9/(us/1e6):.1f}")
    out["flash_attention_wgmma"] = {"plain_us": us, "flops": flops}
    if kernels:
        def kernel(a, b):
            return ops.flash_attention(a, b, b, causal=True)

        err = _err(kernel(qq, kk), plain(qq, kk))
        us = _time(kernel, qq, kk)
        emit(f"attention_kernel_{tag}", us,
             f"GFLOPs={flops/1e9/(us/1e6):.1f} max_abs_err={err:g}")
        out["flash_attention_wgmma"].update(kernel_us=us, max_abs_err=err)
    return out


if __name__ == "__main__":
    cli(main)
