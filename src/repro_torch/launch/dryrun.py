"""Dry-run: trace and cost every (arch × shape × mesh) cell for one H100,
on fake tensors — no card needed, nothing launched.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dry.jsonl

Per cell this program (the reference's ``repro/launch/dryrun.py``, which
lowers and compiles with XLA instead):

1. builds the step the port runs — ``make_train_step`` (loss, autograd
   gradients, AdamW), ``make_prefill_step`` or ``make_decode_step`` — and
   its arguments as ``meta`` trees: parameters, optimizer state, batch or
   caches at the cell's full size;
2. runs it once through :func:`.roofline.trace_cost` on fake tensors: its
   FLOPs, the bytes its ops move, and its memory (arguments, outputs, the
   peak of live storages) — does it fit the card's 80 GB?;
3. traces each block of ``Model.block_fns`` alone and records it, with
   ``outside_blocks = full - Σ count·block``: what the step costs outside
   the layer groups (embedding, head, loss, ``vision_proj``, the optimizer;
   with remat, less the last product of each group, which a block's
   recompute runs and the full step's stops before);
4. takes the roofline terms of the full trace, and appends one JSON
   record to ``--out``.

An eager trace runs every layer, so the full trace is the total: the
reference's ``full + (count - 1)·block`` composition (XLA counts a scan's
body once) is not applied.

Mesh kinds: ``host`` (the default) is one card — the port's steps run on
one device: ``make_host_mesh(device=trace_device())``.
``single`` and ``multi`` (the reference's production meshes, in their H100
layout in :func:`.mesh.make_production_mesh`) and any ``--rules`` but
``default`` are recorded as skipped: they need sharding rules, and the
``dist`` module that would hold them is in neither package.

Under fake tensors the MoE layers keep their static capacity
(``models/moe.py``): the reference's buffer shape, an upper bound on what a
card allocates; such records say ``"moe_capacity": "static"``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, Tuple

from ..configs import ARCHS, SHAPES, ShapeConfig, get_config
from ..models.model import build_model
from ..train.train_step import (make_decode_step, make_prefill_step,
                                make_train_step)
from .mesh import HBM_BYTES, make_host_mesh, make_production_mesh
from .roofline import (GraphCost, analytic_model_flops, roofline_terms,
                       trace_cost, trace_device)

NO_RULES = "no sharding rules: `dist` is in neither package"
COMPOSITION = ("none: an eager trace runs every layer, so the full trace is "
               "the total")


def run_cell(arch: str, shape_name: str, mesh_kind: str = "host",
             rules_name: str = "default", remat: bool = True,
             microbatch: int = 1, verbose: bool = True) -> Dict[str, Any]:
    cfg = get_config(arch)
    ok, reason = cfg.supports(shape_name)
    if ok and (mesh_kind != "host" or rules_name != "default"):
        ok, reason = False, NO_RULES
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "rules": rules_name, "status": "skipped", "reason": reason}
        if mesh_kind in ("single", "multi"):     # the layout it would need
            rec["n_devices"] = make_production_mesh(
                multi_pod=mesh_kind == "multi").size
        return rec
    return run_shape(arch, SHAPES[shape_name], remat=remat,
                     microbatch=microbatch, verbose=verbose)


def _step_and_args(model, shape: ShapeConfig, remat: bool, microbatch: int
                   ) -> Tuple[Any, Tuple[Any, ...]]:
    cfg = model.cfg
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        fn, specs = make_train_step(cfg, remat=remat, microbatch=microbatch)
        return fn, (specs["abstract_params"], specs["abstract_opt"],
                    model.input_specs(T, B, "train"))
    if shape.kind == "prefill":
        fn, specs = make_prefill_step(cfg)
        return fn, (specs["abstract_params"],
                    model.input_specs(T, B, "prefill"))
    fn, specs = make_decode_step(cfg, cache_batch=B, cache_seq=T)
    token = model.input_specs(T, B, "decode")["token"]
    # the last position of a full cache (decode reads all of it anyway)
    return fn, (specs["abstract_params"], specs["abstract_caches"], token,
                T - 1)


def _block_cost(blk) -> Tuple[GraphCost, Dict[str, Any]]:
    """Trace one block of ``Model.block_fns`` alone; return its cost."""
    ab = blk["abstract"]
    args = [ab[k] for k in ("bp", "cache", "x", "vis", "cache_len")
            if k in ab]
    cost, mem = trace_cost(blk["fn"], *args)
    return cost, {"name": blk["name"], "count": blk["count"],
                  "flops_per_dev": cost.flops,
                  "bytes_per_dev": cost.bytes_accessed,
                  "link_bytes_per_dev": cost.collectives.link_bytes,
                  "peak_bytes_per_dev": mem["peak_bytes"]}


def run_shape(arch: str, shape: ShapeConfig, *, remat: bool = True,
              microbatch: int = 1, verbose: bool = True) -> Dict[str, Any]:
    """The record of one cell on the ``host`` mesh, at any shape."""
    cfg = get_config(arch)
    model = build_model(cfg)
    mesh = make_host_mesh(device=trace_device())     # the one faked card
    t0 = time.perf_counter()
    fn, args = _step_and_args(model, shape, remat, microbatch)
    full, mem = trace_cost(fn, *args)
    inside, blocks = GraphCost(), []
    for blk in model.block_fns(shape.kind, shape.seq_len, shape.global_batch,
                               remat=remat):
        cost, meta = _block_cost(blk)
        inside = inside + cost.scaled(blk["count"])
        blocks.append(meta)
    trace_s = time.perf_counter() - t0
    outside = full + inside.scaled(-1.0)

    n_active = model.n_active_params()
    mf = analytic_model_flops(cfg, shape.seq_len, shape.global_batch,
                              shape.kind, model.n_params(), n_active)
    roof = roofline_terms(full, mesh.size, mf)
    peak = mem["peak_bytes"]
    rec = {
        "arch": arch, "shape": shape.name, "mesh": "host",
        "rules": "default", "status": "ok",
        "n_devices": mesh.size, "device": f"fake {mesh.devices[0]}",
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind, "remat": remat, "microbatch": microbatch,
        "n_params": model.n_params(), "n_active_params": n_active,
        "trace_s": round(trace_s, 2),
        "memory": {
            "args_bytes_per_dev": mem["args_bytes"],
            "output_bytes_per_dev": mem["output_bytes"],
            "temp_bytes_per_dev": mem["temp_bytes"],
            "peak_bytes_per_dev": peak,
            "fits_hbm": bool(peak <= HBM_BYTES),
        },
        "full_graph": {
            "flops_per_dev": full.flops,
            "bytes_per_dev": full.bytes_accessed,
            "collectives": full.collectives.counts,
            "link_bytes_per_dev": full.collectives.link_bytes,
        },
        "collective_by_op": full.collectives.by_op,
        "blocks": blocks,
        "outside_blocks": {"flops_per_dev": outside.flops,
                           "bytes_per_dev": outside.bytes_accessed},
        "composition": COMPOSITION,
        "roofline": roof.as_dict(),
    }
    if cfg.n_experts:
        rec["moe_capacity"] = "static"
    if verbose:
        gb = 1e9
        print(f"[{arch} × {shape.name} × host] memory (fake "
              f"{mesh.devices[0]}):")
        print(f"  args/dev   = {mem['args_bytes'] / gb:10.3f} GB")
        print(f"  output/dev = {mem['output_bytes'] / gb:10.3f} GB")
        print(f"  temp/dev   = {mem['temp_bytes'] / gb:10.3f} GB")
        print(f"  counted: flops/dev={full.flops:.3e} "
              f"bytes/dev={full.bytes_accessed:.3e}")
        print(f"  roofline: compute={roof.compute_s * 1e3:.2f}ms "
              f"memory={roof.memory_s * 1e3:.2f}ms "
              f"collective={roof.collective_s * 1e3:.2f}ms "
              f"-> bottleneck={roof.bottleneck} "
              f"(useful_ratio={roof.useful_ratio:.2f}, "
              f"mfu_bound={roof.mfu_bound:.2%})")
        print(f"  trace={trace_s:.1f}s peak/dev={peak / gb:.2f} GB "
              f"fits_h100={peak <= HBM_BYTES}")
    return rec


def iter_cells(mesh_kind: str):
    meshes = ["single", "multi"] if mesh_kind == "both" else [mesh_kind]
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            ok, _ = cfg.supports(shape_name)
            for mk in meshes:
                yield arch, shape_name, mk, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi", "both"])
    ap.add_argument("--rules", default="default")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, m) for a, s, m, ok in iter_cells(args.mesh) if ok]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        cells = [(args.arch, args.shape, m) for m in meshes]

    records, failures = [], 0
    for arch, shape_name, mk in cells:
        try:
            rec = run_cell(arch, shape_name, mk, rules_name=args.rules,
                           remat=not args.no_remat, microbatch=args.microbatch)
        except Exception as e:                              # noqa: BLE001
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape_name, "mesh": mk,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"dry-run: {len(records) - failures}/{len(records)} cells ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
