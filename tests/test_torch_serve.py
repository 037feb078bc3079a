"""The port's serving path vs the JAX reference's own entry points:
``Model.forward``, ``loss_fn``, ``prefill`` (logits and every cache leaf),
``decode_step``, ``grow_caches`` and ``Engine.generate`` (greedy tokens
equal), then the port's own "cached decode == full re-forward" check (the
reference's ``tests/test_serve.py``), the spec trees of caches and inputs,
and the launcher.

The reference's forwards import ``repro.dist.sharding``, absent from the
repository: the ``reference_dist`` fixture registers, for one test at a
time, a stand-in whose ``logical_constraint`` is the identity (what it is
on one device).  Reduced configurations at f32 with the reference's seeded
parameters carried across; tolerances are the reference's own
(``tests/test_models_parity.py``): ``2e-4`` for forward and prefill, ``5e-4``
for decode.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild_model
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import grow_caches as jgrow_caches
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fm
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, build_model, is_spec
from repro_torch.serve import Engine, grow_caches
from torch_parity import (FORWARD_ARCHS, plain_attention_layers,
                          reduced_pair, vision_embeds)
from torch_parity import reference_dist  # noqa: F401  (a fixture)

DECODERS = [a for a in FORWARD_ARCHS if a != "hubert-xlarge"]
B, T, NEW = 2, 30, 4


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, jmodel, jparams, cfg, model, params = reduced_pair(arch)
    rng = np.random.default_rng(len(arch))
    if cfg.family == "audio":
        frames = rng.standard_normal((B, T + NEW, cfg.frontend_dim)).astype(
            np.float32)
        return (jcfg, jmodel, jparams, cfg, model, params,
                {"frames": frames})
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T + NEW)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = vision_embeds(cfg, B)
    return jcfg, jmodel, jparams, cfg, model, params, batch


def _cut(batch, n):
    """The batch's first ``n`` positions (the vision embeddings whole)."""
    return {k: v if k == "vision_embeds" else v[:, :n]
            for k, v in batch.items()}


def _jbatch(batch, n=None):
    return {k: jnp.asarray(v) for k, v in _cut(batch, n).items()}


def _tbatch(batch, n=None):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _cut(batch, n).items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _jleaves(tree):
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p), a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_equals_reference(arch, reference_dist):
    jcfg, jmodel, jparams, cfg, model, params, batch = _setup(arch)
    want, jaux = jax.jit(jmodel.forward)(jparams, _jbatch(batch))
    attention.reset_counts()
    got, aux = model.forward(params, _tbatch(batch))
    assert tuple(got.shape) == want.shape
    _close(got, want, 2e-4)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    # gemma2's attention softcap and MLA's Dv != D are outside the kernel's
    # contract
    assert attention.attention_plain_calls == plain_attention_layers(model)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b"])
def test_loss_fn_equals_reference(arch, reference_dist):
    jcfg, jmodel, jparams, cfg, model, params, batch = _setup(arch)
    labels = np.roll(batch["tokens"], -1, axis=1)
    want = jax.jit(jmodel.loss_fn)(jparams, dict(_jbatch(batch),
                                                 labels=jnp.asarray(labels)))
    got = model.loss_fn(params, dict(_tbatch(batch),
                                     labels=torch.from_numpy(labels)))
    assert abs(float(got) - float(want)) <= 2e-4 * abs(float(want))


def _prefill_both(arch):
    jcfg, jmodel, jparams, cfg, model, params, batch = _setup(arch)
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams, _jbatch(batch, T))
    logits, caches = model.prefill(params, _tbatch(batch, T))
    return jlogits, jcaches, logits, caches


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_equals_reference(arch, reference_dist):
    jlogits, jcaches, logits, caches = _prefill_both(arch)
    assert tuple(logits.shape) == jlogits.shape
    _close(logits, jlogits, 2e-4)
    want = _jleaves(jcaches)
    got = tree_util.leaves_with_path(caches)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape, path
        _close(t, a, 2e-4)


@pytest.mark.parametrize("arch", DECODERS)
def test_grow_caches_equals_reference(arch, reference_dist):
    jcfg, jmodel, jparams, cfg, model, params, batch = _setup(arch)
    _, jcaches, _, caches = _prefill_both(arch)
    want = _jleaves(jgrow_caches(jmodel, jcaches, 3))
    got = tree_util.leaves_with_path(grow_caches(model, caches, 3))
    for (path, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape, path
        _close(t, a, 2e-4)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_equals_reference(arch, reference_dist):
    jcfg, jmodel, jparams, cfg, model, params, batch = _setup(arch)
    _, jcaches, _, caches = _prefill_both(arch)
    jcaches = jgrow_caches(jmodel, jcaches, NEW)
    caches = grow_caches(model, caches, NEW)
    decode = jax.jit(jmodel.decode_step)
    for i in range(NEW):
        tok = batch["tokens"][:, T + i:T + i + 1]
        want, jcaches = decode(jparams, jcaches, jnp.asarray(tok),
                               jnp.asarray(T + i, jnp.int32))
        got, caches = model.decode_step(params, caches, torch.from_numpy(tok),
                                        T + i)
        _close(got, want, 5e-4)
    for (path, t), (_, a) in zip(tree_util.leaves_with_path(caches),
                                 _jleaves(jcaches)):
        _close(t, a, 5e-4)


@pytest.mark.parametrize("arch", DECODERS)
def test_engine_generate_equals_reference(arch, reference_dist):
    """Greedy tokens equal, token for token."""
    jcfg, jmodel, jparams, cfg, model, params, batch = _setup(arch)
    want, jstats = JEngine(jcfg, jparams).generate(_jbatch(batch, T),
                                                   max_new=NEW)
    fm.reset_launches()
    got, stats = Engine(cfg, params, device="cpu").generate(_cut(batch, T),
                                                           max_new=NEW)
    assert fm.launches == 0
    assert got.dtype == np.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (stats.prompt_len, stats.generated) == (jstats.prompt_len,
                                                   jstats.generated)
    assert stats.tokens_per_s > 0 and stats.prefill_s >= 0


@pytest.mark.parametrize("arch", DECODERS)
def test_cached_decode_equals_recompute(arch):
    """The port on its own: greedy tokens of the cached engine equal the
    argmax of a full re-forward at every step (gemma2's ring cache of 32
    slots wraps at T = 30 + 4)."""
    _, _, _, cfg, model, params, batch = _setup(arch)
    gen, _ = Engine(cfg, params, device="cpu").generate(_cut(batch, T),
                                                       max_new=NEW)
    full = _tbatch(batch, T)
    toks = full["tokens"]
    for i in range(NEW):
        logits, _ = model.forward(params, dict(full, tokens=toks))
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        assert (nxt[:, 0].numpy() == gen[:, i]).all(), f"step {i}"
        toks = torch.cat([toks, nxt.to(toks.dtype)], dim=1)


def test_temperature_sampling_is_seeded():
    _, _, _, cfg, model, params, batch = _setup("llama3.2-1b")
    prompt = {"tokens": batch["tokens"][:, :T]}
    a, _ = Engine(cfg, params, temperature=1.0, seed=5,
                  device="cpu").generate(prompt, max_new=NEW)
    b, _ = Engine(cfg, params, temperature=1.0, seed=5,
                  device="cpu").generate(prompt, max_new=NEW)
    np.testing.assert_array_equal(a, b)
    assert ((0 <= a) & (a < cfg.vocab)).all()


def test_engine_needs_a_card_unless_asked_for_the_cpu():
    _, _, _, cfg, model, params, _ = _setup("llama3.2-1b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--batch", "1", "--prompt", "4", "--max-new", "1"])
    with pytest.raises(ValueError, match="parameters on cpu"):
        Engine(cfg, params, device="meta")


def test_launch_serve_runs_on_the_cpu(capsys):
    assert launch_serve.main(["--device", "cpu", "--arch", "llama3.2-1b-smoke",
                              "--batch", "2", "--prompt", "12",
                              "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "served llama3.2-1b-smoke on cpu: batch=2 prompt=12 generated=3" \
        in out
    assert "flash kernel launches 0; plain attention calls 0" in out


def test_launch_serve_gives_a_vlm_its_vision_embeddings(capsys):
    """A ``vlm`` arch is served with seeded vision embeddings, as the
    reference's launcher does: its cross-attention layers run."""
    assert launch_serve.main(["--device", "cpu", "--arch",
                              "llama-3.2-vision-11b-smoke", "--batch", "2",
                              "--prompt", "12", "--max-new", "2"]) == 0
    out = capsys.readouterr().out
    assert ("served llama-3.2-vision-11b-smoke on cpu: batch=2 prompt=12 "
            "generated=2") in out


# ------------------------------------------------------------ spec trees

def _spec_rows(tree, is_leaf):
    return [(p, tuple(s.shape), str(s.dtype).removeprefix("torch."),
             getattr(s, "axes", None))
            for p, s in tree_util.leaves_with_path(tree, is_leaf=is_leaf)]


def _jspec_rows(tree, is_leaf=None):
    out = []
    for p, s in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf):
        path = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
        out.append((path, tuple(s.shape), jnp.dtype(s.dtype).name,
                    getattr(s, "axes", None)))
    return out


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_cache_param_specs_equal_reference(arch):
    from repro.models.common import is_spec as jis_spec
    want = jbuild_model(jget_config(arch)).cache_param_specs(4, 1024)
    got = build_model(get_config(arch)).cache_param_specs(4, 1024)
    assert _spec_rows(got, is_spec) == _jspec_rows(want, jis_spec)


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in JAX_ARCHS for k in ("train", "prefill", "decode")
    if not (k == "decode" and jget_config(a).is_encoder)])
def test_input_specs_equal_reference(arch, kind):
    cfg = get_config(arch)
    want = jbuild_model(jget_config(arch)).input_specs(256, 2, kind)
    got = build_model(cfg).input_specs(256, 2, kind)
    rows = _spec_rows(got, lambda t: isinstance(t, torch.Tensor))
    assert all(t.device.type == "meta" for t in tree_util.leaves(got))
    assert [r[:3] for r in rows] == [r[:3] for r in _jspec_rows(want)]
