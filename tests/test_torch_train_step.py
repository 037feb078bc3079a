"""The port's one-device train, prefill and decode steps
(``repro_torch.train.train_step``).

The reference's ``repro/train/train_step.py`` imports ``repro.dist.sharding``
at module top, which is not in the repository, so it cannot run: a train
step is held against the reference's step composed from its runnable parts,
``jax.value_and_grad(Model.loss_fn)`` and ``AdamW.update`` (as
``tests/test_models_smoke.py`` composes it), on a reduced configuration at
f32 through the ``reference_dist`` fixture (``tests/torch_parity.py``).
Tolerances: the loss ``1e-5`` relative; moments and parameters ``1e-4`` of
each leaf's largest magnitude (of the moment, or of the parameter's change),
with AdamW's ``eps`` raised to ``1e-3`` (see ``OPT``).
``microbatch=2`` against ``microbatch=1``: ``1e-6`` of each leaf's largest
magnitude (the same gradients, summed in two halves).  ``abstract_state``
and the steps' spec trees against the reference's shapes and dtypes, all ten
configurations.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild_model
from repro.train.optimizer import AdamW as JAdamW
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import (make_decode_step, make_prefill_step,
                                          make_train_step, value_and_grad)
from torch_parity import client_batches, leaves_close, reduced_pair
from torch_parity import reference_dist  # noqa: F401  (a fixture)

B, T = 4, 16
# eps 1e-3, not the default 1e-8: the first AdamW step moves an element by
# lr·g/(|g| + eps), and where |g| is near eps an f32 rounding difference in g
# (two autodiff programs sum in different orders) moves that by a percent of
# lr; at 1e-3 the update is a well-conditioned function of the gradient
OPT = dict(lr=1e-3, eps=1e-3, weight_decay=0.1, grad_clip=1.0)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    return (reduced_pair(arch, n_layers=2, vocab=128),
            {k: v[0] for k, v in client_batches(128, T, B, 1).items()})


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "stablelm-1.6b"])
def test_train_step_equals_the_reference_composition(arch, reference_dist):
    (jcfg, jmodel, jparams, cfg, model, params), batch = _setup(arch)
    jopt = JAdamW(**OPT)

    @jax.jit
    def jstep(p, s, b):
        loss, grads = jax.value_and_grad(jmodel.loss_fn)(p, b)
        p2, s2 = jopt.update(grads, s, p)
        return loss, p2, s2

    jloss, jp, js = jstep(jparams, jopt.init(jparams),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    opt = AdamW(**OPT)
    step, specs = make_train_step(cfg, optimizer=opt)
    loss, p, s = step(params, opt.init(params), _tbatch(batch))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert int(s.step) == int(js.step) == 1
    leaves_close(s.mu, js.mu, 1e-4, "mu")
    leaves_close(s.nu, js.nu, 1e-4, "nu")
    # the parameters' change, leaf by leaf
    dp = tree_util.map(lambda a, b: a - b, p, params)
    jdp = jax.tree.map(lambda a, b: a - b, jp, jparams)
    leaves_close(dp, jdp, 1e-4, "params")


def test_remat_step_equals_plain_step():
    (_, _, _, cfg, model, params), batch = _setup("llama3.2-1b")
    opt = AdamW(**OPT)
    outs = [make_train_step(cfg, optimizer=opt, remat=r)[0](
        params, opt.init(params), _tbatch(batch)) for r in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_util.leaves(outs[0][1:]),
                    tree_util.leaves(outs[1][1:])):
        assert torch.equal(a, b)


def test_microbatch_two_equals_one():
    (_, _, _, cfg, model, params), batch = _setup("llama3.2-1b")
    opt = AdamW(**OPT)
    l1, p1, s1 = make_train_step(cfg, optimizer=opt)[0](
        params, opt.init(params), _tbatch(batch))
    l2, p2, s2 = make_train_step(cfg, optimizer=opt, microbatch=2)[0](
        params, opt.init(params), _tbatch(batch))
    assert l2.dtype == torch.float32
    assert abs(float(l2) - float(l1)) <= 1e-6 * abs(float(l1))
    for name, a, b in (("mu", s2.mu, s1.mu), ("nu", s2.nu, s1.nu)):
        for x, y in zip(tree_util.leaves(a), tree_util.leaves(b)):
            assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max()), \
                name
    for x, y in zip(tree_util.leaves(p2), tree_util.leaves(p1)):
        assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max())


def test_microbatch_divides_by_a_tensor():
    """The accumulated gradient is divided by ``microbatch`` as an f32
    tensor: on the CPU too the quotient is a true division, ``g / 3``, not
    ``g * (1/3)``."""
    (_, _, _, cfg, model, params), batch = _setup("llama3.2-1b")
    batch = {k: np.concatenate([v, v[:2]]) for k, v in batch.items()}  # B 6
    captured = {}

    class Spy(AdamW):
        def update(self, grads, state, p):
            captured["g"] = grads
            return super().update(grads, state, p)

    opt = Spy(**OPT)
    make_train_step(cfg, optimizer=opt, microbatch=3)[0](
        params, opt.init(params), _tbatch(batch))
    tb = _tbatch(batch)
    total = None
    for m in range(3):
        _, g = value_and_grad(model.loss_fn, params,
                              {k: v[2 * m:2 * m + 2] for k, v in tb.items()})
        total = g if total is None else tree_util.map(torch.add, total, g)
    three = torch.full((), 3.0)
    for got, acc in zip(tree_util.leaves(captured["g"]),
                        tree_util.leaves(total)):
        assert torch.equal(got, acc / three)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_equals_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = AdamW().abstract_state(build_model(cfg).abstract_params())
    want = JAdamW().abstract_state(jbuild_model(jcfg).abstract_params())
    assert got.step.device.type == "meta" and got.step.dtype == torch.int32
    assert tuple(got.step.shape) == want.step.shape == ()
    for part in ("mu", "nu"):
        g = tree_util.leaves_with_path(getattr(got, part))
        w = jax.tree_util.tree_leaves_with_path(getattr(want, part))
        assert len(g) == len(w)
        for (gp, gl), (wp, wl) in zip(g, w):
            assert gp == tuple(getattr(k, "key", None) for k in wp)
            assert tuple(gl.shape) == wl.shape
            assert gl.dtype == torch.float32 and wl.dtype == jnp.float32
            assert gl.device.type == "meta"


def test_train_step_specs_are_abstract():
    cfg = get_config("llama3.2-1b")
    _, specs = make_train_step(cfg)
    n = sum(t.numel() for t in tree_util.leaves(specs["abstract_params"]))
    assert n == build_model(cfg).n_params() == 1_235_814_400
    assert all(t.device.type == "meta"
               for t in tree_util.leaves(specs["abstract_opt"]))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b"])
def test_prefill_and_decode_steps_equal_reference(arch, reference_dist):
    (jcfg, jmodel, jparams, cfg, model, params), batch = _setup(arch)
    tokens = batch["tokens"][:, :12]
    prefill, pspecs = make_prefill_step(cfg)
    decode, dspecs = make_decode_step(cfg, cache_batch=B, cache_seq=13)
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams,
                                               {"tokens": jnp.asarray(tokens)})
    logits, caches = prefill(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    assert logits.grad_fn is None
    # decode one token against a cache grown by one slot (as the engine
    # does), here by padding the prefill caches
    from repro_torch.serve import grow_caches
    caches = grow_caches(model, caches, 1)
    tok = torch.from_numpy(batch["tokens"][:, 12:13].copy())
    dlogits, _ = decode(params, caches, tok, 12)
    full = model.forward(params, {"tokens": torch.from_numpy(
        batch["tokens"][:, :13].copy())})[0][:, -1:]
    np.testing.assert_allclose(dlogits.numpy(), full.detach().numpy(),
                               rtol=5e-4, atol=5e-4)
    shapes = [tuple(t.shape)
              for t in tree_util.leaves(dspecs["abstract_caches"])]
    assert shapes == [tuple(s.shape) for s in jax.tree.leaves(
        jmodel.cache_param_specs(B, 13), is_leaf=lambda x: hasattr(x, "axes"))]
    assert all(t.device.type == "meta"
               for t in tree_util.leaves(pspecs["abstract_params"]))
