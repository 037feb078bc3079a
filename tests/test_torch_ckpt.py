"""The port's checkpoints (``repro_torch.ckpt.checkpoint``): the cases of the
reference's ``tests/test_ckpt.py`` (roundtrip, structure and shape
mismatches, a writer killed mid-write, listdir noise, pruning, no partial
checkpoint visible, the async checkpointer), checkpoints carried across the
two packages both ways — bf16 leaves and a ``(params, AdamWState)`` tuple
among them — and ``python -m repro_torch.launch.train`` on the CPU resuming
from its own checkpoint."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild_model
from repro.train.optimizer import AdamW as JAdamW
from repro_torch import tree as tree_util
from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, latest_step,
                                         prune, restore, save)
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.train.optimizer import AdamW, AdamWState
from torch_parity import CPU  # noqa: F401  (sets torch's thread count)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((16, 8)).astype(
                np.float32)),
            "inner": {"b": torch.from_numpy(rng.standard_normal(8).astype(
                          np.float32)),
                      "step": torch.tensor(7, dtype=torch.int32)}}


def _assert_trees_equal(a, b):
    la, lb = tree_util.leaves(a), tree_util.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 5, t, extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 5
    out, manifest = restore(str(tmp_path), t, device="cpu")
    assert manifest["step"] == 5 and manifest["extra"]["note"] == "x"
    _assert_trees_equal(out, t)


def test_restore_structure_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, _tree())
    bad = {"w": torch.zeros((16, 8)), "other": torch.zeros(3)}
    with pytest.raises(ValueError, match="structure mismatch"):
        restore(str(tmp_path), bad, device="cpu")


def test_restore_shape_mismatch_names_leaf(tmp_path):
    save(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["w"] = torch.zeros((4, 8), dtype=torch.float32)
    with pytest.raises(ValueError, match="'w'"):
        restore(str(tmp_path), bad, device="cpu")


def test_crash_mid_write_recovery(tmp_path):
    """A writer killed mid-write leaves a .tmp-step_* dir: readers ignore
    it, the next save sweeps it, and restore serves the last committed
    step."""
    t = _tree()
    save(str(tmp_path), 1, t)
    junk = tmp_path / ".tmp-step_00000002"
    os.makedirs(junk)
    (junk / "arrays.npz").write_bytes(b"partial garbage")
    assert latest_step(str(tmp_path)) == 1          # never visible
    out, manifest = restore(str(tmp_path), t, device="cpu")
    assert manifest["step"] == 1
    _assert_trees_equal(out, t)
    save(str(tmp_path), 3, _tree(3))                # sweeps the leftovers
    assert not junk.exists()
    assert latest_step(str(tmp_path)) == 3


def test_listdir_noise_tolerated(tmp_path):
    save(str(tmp_path), 4, _tree())
    (tmp_path / "step_notanumber").mkdir()
    (tmp_path / "stepfile.txt").write_text("x")
    assert latest_step(str(tmp_path)) == 4
    prune(str(tmp_path), keep=1)
    assert latest_step(str(tmp_path)) == 4


def test_latest_and_prune(tmp_path):
    for s in (1, 3, 7, 9):
        save(str(tmp_path), s, _tree(s))
    assert latest_step(str(tmp_path)) == 9
    prune(str(tmp_path), keep=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [7, 9]


def test_no_partial_checkpoint_visible(tmp_path):
    os.makedirs(tmp_path / ".tmp-step_00000042")
    assert latest_step(str(tmp_path)) is None
    assert latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), _tree(), device="cpu")


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(4):
        ck.save(s, _tree(s))
    ck.wait()
    assert latest_step(str(tmp_path)) == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    out, _ = restore(str(tmp_path), _tree(), device="cpu")
    _assert_trees_equal(out, _tree(3))


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """The host copy is taken on the caller's thread: changing the tensors
    after ``save`` returns does not change what is written."""
    ck = AsyncCheckpointer(str(tmp_path))
    t = _tree()
    want = tree_util.map(lambda x: x.clone(), t)
    ck.save(0, t)
    t["w"].add_(1.0)
    ck.wait()
    _assert_trees_equal(restore(str(tmp_path), want, device="cpu")[0], want)


def test_async_checkpointer_raises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(0, _tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                       # raised once


def test_restore_needs_a_device_unless_asked_for_the_cpu(tmp_path):
    save(str(tmp_path), 0, _tree())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        restore(str(tmp_path), _tree())


# ------------------------------------------------ across the two packages

def _train_state_pair(seed=0):
    """A bf16 llama3.2-1b-smoke parameter tree and a one-step AdamW state,
    in both packages, equal bit for bit."""
    jmodel = jbuild_model(jget_config("llama3.2-1b-smoke"))
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    jopt = JAdamW(lr=1e-2)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), jparams)
    jparams, jstate = jopt.update(grads, jopt.init(jparams), jparams)
    return jparams, jstate


def _from_jax(tree):
    """A reference tree as the port's: bf16 through its bits."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    params, state = tree
    return (tree_util.map(one, jax.tree.map(np.asarray, params)),
            AdamWState(one(state.step), *(tree_util.map(
                one, jax.tree.map(np.asarray, getattr(state, f)))
                for f in ("mu", "nu"))))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jparams, jstate = _train_state_pair()
    jckpt.save(str(tmp_path), 3, (jparams, jstate), extra={"by": "jax"})
    model = build_model(get_config("llama3.2-1b-smoke"))
    like = (model.abstract_params(),
            AdamW().abstract_state(model.abstract_params()))
    (params, state), manifest = restore(str(tmp_path), like, device="cpu")
    assert manifest["step"] == 3 and manifest["extra"] == {"by": "jax"}
    assert params["embed"].dtype == torch.bfloat16
    assert isinstance(state, AdamWState) and state.step.dtype == torch.int32
    _assert_trees_equal((params, state), _from_jax((jparams, jstate)))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jparams, jstate = _train_state_pair(1)
    tree = _from_jax((jparams, jstate))
    save(str(tmp_path), 5, tree)
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"]["0/embed"] == "bfloat16"
    assert manifest["dtypes"]["1/step"] == "int32"
    assert "1/mu/blocks0/l0/attn/wq" in manifest["names"]
    (rparams, rstate), _ = jckpt.restore(str(tmp_path), (jparams, jstate))
    for a, b in zip(jax.tree.leaves((rparams, rstate)),
                    jax.tree.leaves((jparams, jstate))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))


def test_leaf_names_are_the_references(tmp_path):
    jparams, jstate = _train_state_pair()
    jckpt.save(str(tmp_path / "j"), 0, (jparams, jstate))
    save(str(tmp_path / "t"), 0, _from_jax((jparams, jstate)))
    read = [json.load(open(tmp_path / d / "step_00000000" / "manifest.json"))
            for d in ("j", "t")]
    assert read[0]["names"] == read[1]["names"]
    assert read[0]["dtypes"] == read[1]["dtypes"]


# ----------------------------------------------------------- the trainer

ARGS = ["--arch", "llama3.2-1b-smoke", "--batch", "2", "--seq", "16",
        "--device", "cpu", "--log-every", "1", "--ckpt-every", "2"]


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    ck = ["--ckpt-dir", str(tmp_path)]
    first = launch_train.run(ARGS + ck + ["--steps", "4"])
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000003"]
    # what was saved is what the run ended with, bit for bit
    saved, _ = restore(str(tmp_path), (first["params"], first["opt_state"]),
                       device="cpu")
    _assert_trees_equal(saved, (first["params"], first["opt_state"]))
    assert int(saved[1].step) == 4
    capsys.readouterr()
    assert launch_train.main(ARGS + ck + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert "step     4 loss" in out and "step     3 loss" not in out
    assert latest_step(str(tmp_path)) == 5
    # the resumed run is the uninterrupted one: the same batches, the same
    # state, the same losses (the CPU's sums are deterministic)
    whole = launch_train.run(ARGS + ["--steps", "6"])
    resumed = launch_train.run(ARGS + ck + ["--steps", "6"])
    assert resumed["start"] == 6 and resumed["losses"] == []
    again = restore(str(tmp_path), (whole["params"], whole["opt_state"]),
                    device="cpu")[0]
    _assert_trees_equal(again, (whole["params"], whole["opt_state"]))
    assert all(np.isfinite(whole["losses"]))
    assert whole["losses"][-1] < whole["losses"][0]


def test_launch_train_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1"])
