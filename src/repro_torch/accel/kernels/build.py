"""Build and load the port's CUDA kernels.

The sources are every ``*.cu`` of the two kernel directories,
``repro_torch/accel/kernels/csrc/`` (the scheduler's kernels) and
``repro_torch/kernels/csrc/`` (the federated-learning and attention
kernels), one source list with unique file names.  Each is a
plain-C-interface source (no PyTorch headers): it compiles in seconds with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<hash>/<name>.so csrc/<name>.cu

and is loaded with ``ctypes``.  The build runs at first use, one ``nvcc`` per
source, all started together; the output directory is keyed by a hash of all
sources, so an edited source never meets a stale library.  Importing this
module needs neither ``nvcc`` nor a GPU — only :func:`load_library` does.

Errors are a dedicated class so callers that degrade on *data* problems
(the matcher's guard) never mistake a missing compiler or a refused launch
for one: :class:`KernelError` always propagates.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC_DIRS = (Path(__file__).resolve().parent / "csrc",
             Path(__file__).resolve().parents[2] / "kernels" / "csrc")
BUILD_ROOT = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched."""


class KernelCompileError(KernelError):
    pass


class KernelLaunchError(KernelError):
    pass


_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None      # wall time of this process's build
build_log: str = ""                        # nvcc output (ptxas -v included)


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelCompileError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of repro_torch.accel.kernels cannot be built")


def sources() -> List[Path]:
    """Every kernel source, sorted by file name (names are unique: a
    library is looked up by its source's stem)."""
    srcs = sorted((p for d in CSRC_DIRS for p in d.glob("*.cu")),
                  key=lambda p: p.name)
    names = [p.name for p in srcs]
    if len(set(names)) != len(names):
        raise KernelCompileError(f"kernel source names collide: {names}")
    return srcs


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build_all(out_dir: Path) -> None:
    """One nvcc per source, all started together; atomic rename on success."""
    global build_seconds, build_log
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        final = out_dir / (src.stem + ".so")
        if final.exists():
            continue
        tmp = out_dir / f".{src.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
        procs.append((src, tmp, final, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for src, tmp, final, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(f"{src.name} (exit {p.returncode}):\n{out}")
            continue
        os.replace(tmp, final)
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise KernelCompileError("nvcc failed:\n" + "\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The shared library built from ``<name>.cu`` (building every
    source first if this hash has not been built yet)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    out_dir = BUILD_ROOT / source_hash()
    path = out_dir / (name + ".so")
    if not path.exists():
        _build_all(out_dir)
    if not path.exists():
        raise KernelCompileError(f"no kernel source {name}.cu")
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelCompileError(f"cannot load {path}: {e}") from e
    _libs[name] = lib
    return lib


def check_launch(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA launch failed (error {code})")


def device_context(dev: torch.device):
    """``torch.cuda.device(dev)`` when ``dev`` is not the current device, a
    no-op context when it is (entering one costs more than a small launch)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
