"""The port's dry-run (``repro_torch.launch.dryrun``): ``run_cell`` keeps
the reference's record (``trace_s`` for ``lower_s`` / ``compile_s``) and its
``outside_blocks`` is the head's cost;
the full-size llama3.2-1b × ``train_4k`` cell counts its arguments exactly;
MoE traces at the static capacity; the meshes and rules no package can
shard are skipped; the CLI's exit code."""
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import trace_cost
from repro_torch.models import moe as moe_mod

B, T = 2, 32


def _draw(rng, shape, scale=0.5):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


REFERENCE_KEYS = {"arch", "shape", "mesh", "rules", "status", "n_devices",
                  "n_params", "n_active_params", "memory", "full_graph",
                  "collective_by_op", "blocks", "roofline"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_shape_records_the_head_outside_the_blocks(kind):
    """Outside the layer groups a llama step runs the tied head: ``x @
    embedᵀ`` on every position and its two products in the backward
    (train, no remat), or on the last position (prefill, decode); the
    embedding is a gather and counts no FLOPs."""
    arch = "llama3.2-1b-smoke"
    cfg = get_config(arch)
    rec = dryrun.run_shape(arch, ShapeConfig("small", T, B, kind),
                           remat=False, verbose=False)
    assert REFERENCE_KEYS <= set(rec) and "trace_s" in rec
    assert not {"lower_s", "compile_s"} & set(rec)
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    head = 2 * B * cfg.d_model * cfg.vocab
    want = 3 * T * head if kind == "train" else head
    assert rec["outside_blocks"]["flops_per_dev"] == want
    inside = sum(b["count"] * b["flops_per_dev"] for b in rec["blocks"])
    assert rec["full_graph"]["flops_per_dev"] == inside + want
    assert rec["roofline"]["flops_per_dev"] == rec["full_graph"][
        "flops_per_dev"]
    assert set(rec["memory"]) == {"args_bytes_per_dev", "output_bytes_per_dev",
                                  "temp_bytes_per_dev", "peak_bytes_per_dev",
                                  "fits_hbm"}
    assert rec["memory"]["fits_hbm"] is True
    assert rec["collective_by_op"] == {} and rec["full_graph"][
        "link_bytes_per_dev"] == 0


@pytest.mark.parametrize("arch,shape", [("mamba2-1.3b", "long_500k"),
                                        ("hubert-xlarge", "prefill_32k"),
                                        ("gemma2-27b", "decode_32k")])
def test_run_cell_on_reduced_configs(arch, shape):
    rec = dryrun.run_cell(arch + "-smoke", shape, verbose=False)
    assert rec["status"] == "ok" and REFERENCE_KEYS <= set(rec)
    assert (rec["shape"], rec["mesh"], rec["rules"]) == (shape, "host",
                                                         "default")
    assert rec["seq_len"] == SHAPES[shape].seq_len
    assert rec["roofline"]["step_time_s"] > 0


def test_full_size_llama_train_4k_counts_its_arguments_exactly():
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", verbose=False)
    n = 1_235_814_400
    assert rec["n_params"] == n == rec["n_active_params"]
    shape = SHAPES["train_4k"]
    # bf16 parameters, AdamW's f32 mu and nu, its int32 step, int32 tokens
    # and labels
    batch = 2 * shape.global_batch * shape.seq_len * 4
    assert rec["memory"]["args_bytes_per_dev"] == 2 * n + 8 * n + 4 + batch
    assert rec["memory"]["fits_hbm"] is False     # the logits alone: 269 GB
    assert rec["roofline"]["model_flops"] == 6.0 * n * 4096 * 256


def test_moe_traces_at_the_static_capacity():
    """A capacity far above the load: on real tensors the buffers are cut to
    the largest load; on fake ones the static capacity stays."""
    E, K, D, F, N = 8, 2, 64, 64, 4 * 4096
    rng = np.random.default_rng(5)
    p = {"router": torch.tensor(_draw(rng, (D, E))),
         "w_gate": torch.tensor(_draw(rng, (E, D, F))),
         "w_up": torch.tensor(_draw(rng, (E, D, F))),
         "w_down": torch.tensor(_draw(rng, (E, F, D)))}
    x = torch.tensor(_draw(rng, (4, 4096, D)))
    G = moe_mod.auto_groups(N)
    cap = int(4.0 * K * (N // G) / E)
    assert G * E * cap - N * K > moe_mod.PAD_ROWS     # the cut applies

    def moe(p, x):
        return moe_mod.moe_ffn(p, x, top_k=K, capacity_factor=4.0)
    static = 3 * 2 * E * G * cap * D * F + 2 * N * D * E + 2 * N * K * D
    cost, _ = trace_cost(moe, p, x)
    assert cost.flops == static
    with FlopCounterMode(display=False) as real:
        moe(p, x)
    assert real.get_total_flops() < static
    rec = dryrun.run_shape("mixtral-8x22b-smoke",
                           ShapeConfig("small", T, B, "prefill"),
                           verbose=False)
    assert rec["moe_capacity"] == "static"


@pytest.mark.parametrize("mesh,rules", [("single", "default"),
                                        ("multi", "default"),
                                        ("host", "long_context")])
def test_meshes_and_rules_without_sharding_are_skipped(mesh, rules):
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", mesh, rules_name=rules)
    assert rec["status"] == "skipped" and rec["reason"] == dryrun.NO_RULES
    assert (rec["mesh"], rec["rules"]) == (mesh, rules)
    # the H100 layout the production meshes would span
    assert rec.get("n_devices") == {"single": 256, "multi": 512}.get(mesh)
    # a cell the config does not support keeps the config's reason
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", mesh, rules_name=rules)
    assert rec["status"] == "skipped" and "500k" in rec["reason"]


def test_cli_exit_code(tmp_path, monkeypatch, capsys):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "llama3.2-1b-smoke", "--shape",
                        "decode_32k", "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                        "--mesh", "both", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok", "skipped", "skipped"]

    def broken(arch, shape, *a, **k):
        if shape == "prefill_32k":
            raise RuntimeError("trace failed")
        return {"arch": arch, "shape": shape, "status": "ok"}
    monkeypatch.setattr(dryrun, "run_cell", broken)
    assert dryrun.main(["--all", "--out", str(out)]) == 1
    assert "cells ok" in capsys.readouterr().out
    recs = [json.loads(line) for line in out.read_text().splitlines()][3:]
    assert len(recs) == sum(ok for *_, ok in dryrun.iter_cells("host"))
    assert {r["status"] for r in recs} == {"ok", "error"}
    assert sum(r["status"] == "error" for r in recs) == 10
