"""The port's elastic restart (``repro_torch.launch.elastic``) on the CPU at
smoke size: the restored tree is bit-equal to the saved one, phase 2's
losses equal an uninterrupted run's bit for bit, and the checkpoint it
writes is read by the reference's ``repro.ckpt.checkpoint.restore``."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch import tree as tree_util
from repro_torch.launch import elastic

ARGV = ["--arch", "llama3.2-1b-smoke", "--device", "cpu"]


def test_main_restores_bit_equal_and_trains_on(capsys):
    assert elastic.main(ARGV + ["--steps", "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("phase 1 done (loss ")
    assert lines[1].startswith("phase 2: restored step 3 onto mesh "
                               "{'data': 1, 'model': 1}")
    assert lines[1].endswith("bit-equal to the saved tree: True)")
    assert "elastic restart OK" in lines[2]
    assert lines[3].startswith("elastic: {")


def test_phase_2_continues_the_uninterrupted_run_bit_for_bit():
    steps = 3
    res = elastic.run(ARGV + ["--steps", str(steps)])
    assert res["restored_bit_equal"] and res["restored_step"] == steps - 1
    assert len(res["phase1_losses"]) == steps
    assert len(res["phase2_losses"]) == elastic.PHASE2_STEPS
    whole = elastic.run(ARGV + ["--steps", str(steps + elastic.PHASE2_STEPS)])
    assert res["phase1_losses"] + res["phase2_losses"] == \
        whole["phase1_losses"]
    assert all(map(math.isfinite, whole["phase1_losses"]))
    assert res["flash_launches"] == [0, 0]          # the CPU: plain version
    assert res["ckpt_bytes"] == sum(
        t.numel() * t.element_size()
        for t in tree_util.leaves((res["params"], res["opt_state"])))


def test_the_checkpoint_is_read_by_the_reference(monkeypatch):
    """Phase 2's restore, spied on: the reference's ``restore`` reads the
    same directory into the reference's tree, every leaf equal to the
    port's restored leaf bit for bit."""
    port_restore = elastic.restore
    seen = {}

    def spy(ckdir, like, device=None):
        tree, manifest = port_restore(ckdir, like, device=device)
        jlike = jax.tree.map(np.asarray, tree_util.map(
            lambda t: t.float().numpy() if t.dtype == torch.bfloat16
            else t.numpy(), tree))
        jtree, jmanifest = jckpt.restore(ckdir, jlike)
        seen["manifest"] = (manifest["step"], jmanifest["step"])
        for t, a in zip(tree_util.leaves(tree), jax.tree.leaves(jtree)):
            a = np.asarray(a)
            assert tuple(t.shape) == a.shape
            if t.dtype == torch.bfloat16:
                assert str(a.dtype) == "bfloat16"
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
            else:
                assert np.array_equal(t.numpy(), a)
        seen["leaves"] = len(tree_util.leaves(tree))
        return tree, manifest
    monkeypatch.setattr(elastic, "restore", spy)
    res = elastic.run(ARGV + ["--steps", "2"])
    assert seen["manifest"] == (1, 1) and seen["leaves"] > 10
    assert res["restored_bit_equal"]


def test_elastic_runs_on_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic.run(["--steps", "1"])
