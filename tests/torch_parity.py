"""Shared helpers of the ``test_torch_*`` parity tests.

Inputs are made with NumPy from a seed and handed to both packages — the JAX
reference ``repro`` and the port ``repro_torch`` — as plain arrays; the port
runs with ``device="cpu"``.
"""
import math
import sys
import types

import numpy as np
import pytest
import torch

# xdist workers import torch and JAX together: keep torch's intra-op pool
# from oversubscribing the host
torch.set_num_threads(1)

CPU = torch.device("cpu")


class FakeReq:
    def __init__(self, demand, granted=0):
        self.demand, self.granted = demand, granted


class FakeSched:
    """The minimum a ``MatchState`` is built from."""

    def __init__(self, slots):
        self._slots = slots

    def export_match_slots(self, limit=None):
        if limit is None:
            return self._slots
        return [s if s is None else s[:limit] for s in self._slots]


def random_slots(rng):
    """Random candidate rows: a few atoms, a few requests, some tier bands,
    some uncovered atoms."""
    A = int(rng.integers(1, 6))
    R = int(rng.integers(1, 8))
    reqs = [FakeReq(int(rng.integers(1, 6))) for _ in range(R)]
    slots = []
    for _ in range(A):
        if rng.uniform() < 0.1:
            slots.append(None)
            continue
        row = []
        for r in rng.permutation(R)[:int(rng.integers(0, R + 1))]:
            if rng.uniform() < 0.3:
                lo, hi = sorted(rng.uniform(0, 3, 2))
            else:
                lo, hi = -math.inf, math.inf
            row.append((reqs[int(r)], float(lo), float(hi)))
        slots.append(row)
    return slots


def random_segment(rng, state, n):
    cov = np.flatnonzero(state.covered)
    if len(cov) == 0:
        return None, None
    return rng.choice(cov, size=n), rng.uniform(0, 3, size=n)


def state_arrays(state) -> dict:
    """Lift a reference ``MatchState``'s arrays (the input of the port's
    ``match_state_from_numpy``)."""
    return {"cand_req": state.cand_req, "cand_lo": state.cand_lo,
            "cand_hi": state.cand_hi, "remaining": state.remaining,
            "covered": state.covered, "has_cand": state.has_cand,
            "truncated": state.truncated, "kcap": state.kcap}


def assert_mirror_equals(port_state, ref_state) -> None:
    """The port's device mirror, read back, equals the reference's arrays."""
    got = port_state.to_numpy()
    want = state_arrays(ref_state)
    for k in ("cand_req", "cand_lo", "cand_hi", "remaining", "covered",
              "has_cand", "truncated"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["kcap"] == want["kcap"]
    assert port_state.d_cand_req.dtype == torch.int32
    assert port_state.d_cand_lo.dtype == torch.float64


@pytest.fixture
def reference_dist(monkeypatch):
    """The reference's ``Model._head`` and ``Model.forward`` import
    ``repro.dist.sharding.logical_constraint``, and ``repro.dist`` is not in
    the repository.  For one test only, register a module of that name
    whose ``logical_constraint`` returns its argument — exactly what the
    constraint is on one device — so the reference's own entry points
    (``Model.forward``, ``prefill``, ``decode_step``, ``Engine.generate``)
    run unedited.  ``monkeypatch`` removes it after the test, so nothing
    leaks into other test files on the same worker."""
    import repro
    dist = types.ModuleType("repro.dist")
    sharding = types.ModuleType("repro.dist.sharding")
    sharding.logical_constraint = lambda x, *axes: x
    dist.sharding = sharding
    monkeypatch.setitem(sys.modules, "repro.dist", dist)
    monkeypatch.setitem(sys.modules, "repro.dist.sharding", sharding)
    monkeypatch.setattr(repro, "dist", dist, raising=False)
    yield sharding


# every registered configuration: dense, audio, and the MoE, MLA, Mamba-2,
# hybrid and cross-attention families
FORWARD_ARCHS = ("llama3.2-1b", "qwen3-32b", "stablelm-1.6b", "gemma2-27b",
                 "hubert-xlarge", "mixtral-8x22b", "deepseek-v3-671b",
                 "mamba2-1.3b", "jamba-v0.1-52b", "llama-3.2-vision-11b")

# leaves whose init is a constant (zeros or ones) that hides a term of the
# forward — a zero cross-attention gate contributes nothing, a zero router
# bias and the default decay / dt bias / skip exercise one point each —
# and the seeded spread ``reduced_pair`` draws them from instead
SEEDED_LEAVES = {"gate_attn": (0.6, 0.2), "router_bias": (0.0, 0.05),
                 "a_log": (0.0, 0.5), "dt_bias": (0.0, 0.5),
                 "d_skip": (1.0, 0.3)}


def seed_constant_leaves(jparams, seed):
    """The reference's parameter tree with every :data:`SEEDED_LEAVES` leaf
    redrawn as ``mean + std · N(0, 1)`` from NumPy (the same values for both
    packages once carried across)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed + 7919)

    def one(path, a):
        name = getattr(path[-1], "key", None)
        if name not in SEEDED_LEAVES:
            return a
        mean, std = SEEDED_LEAVES[name]
        return jnp.asarray(mean + std * rng.standard_normal(a.shape), a.dtype)
    return jax.tree_util.tree_map_with_path(one, jparams)


def plain_attention_layers(model):
    """Attention calls of one forward outside the kernel's function (MLA's
    ``Dv != D``, gemma2's softcap): ``attention_plain_calls`` after it."""
    cfg = model.cfg
    if not (cfg.use_mla or cfg.attn_softcap > 0):
        return 0
    return sum(g.count * sum(d.mixer == "attn" for d in g.descs)
               for g in model.groups)


def kernel_attention_layers(model):
    """Attention calls of one forward through the flash wrapper: self- and
    cross-attention layers but those of :func:`plain_attention_layers`."""
    n = sum(g.count * sum(d.mixer in ("attn", "cross") for d in g.descs)
            for g in model.groups)
    return n - plain_attention_layers(model)


def vision_embeds(cfg, batch, seed=0):
    """Seeded standard-normal vision embeddings ``(batch, vision_seq,
    vision_dim)`` for a ``vlm`` configuration (f32 NumPy)."""
    rng = np.random.default_rng(seed + 104729)
    return rng.standard_normal((batch, cfg.vision_seq, cfg.vision_dim)
                               ).astype(np.float32)


def reduced_pair(arch, seed=0, **overrides):
    """The reduced configuration of ``arch`` at f32 in both packages, its
    two models, and the reference's seeded parameters cast to f32 (the
    :data:`SEEDED_LEAVES` redrawn) with the port's copy of them on the CPU:
    ``(jcfg, jmodel, jparams, cfg, model, params)``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models.model import build_model as jbuild_model
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_from_jax
    kw = dict(dtype="float32", **overrides)
    jcfg = jget_config(arch).reduced().with_(**kw)
    cfg = get_config(arch).reduced().with_(**kw)
    jmodel = jbuild_model(jcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jmodel.init_params(jax.random.PRNGKey(seed)))
    jparams = seed_constant_leaves(jparams, seed)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, jmodel, jparams, cfg, build_model(cfg), params


# ---- the scenario slice: both packages' specs at the reference tests' size

def tiny(scenarios_mod, spec):
    """``fast_scaled``, then 5 jobs over 1.5 simulated days (the reference's
    ``tests/test_scenarios.py::_tiny``), in either package."""
    from dataclasses import replace
    spec = scenarios_mod.fast_scaled(spec)
    return replace(spec, jobs=replace(spec.jobs, num_jobs=5),
                   sim=replace(spec.sim, max_time=1.5 * 24 * 3600.0))


def tiny_pair(name):
    """The reference's and the port's tiny spec of one registered scenario."""
    import repro.scenarios as ref
    import repro_torch.scenarios as port
    return (tiny(ref, ref.get_scenario(name)),
            tiny(port, port.get_scenario(name)))


def rounds_sig(m):
    return [(r.job_id, r.round_index, r.submit, r.alloc_complete, r.complete,
             r.demand, r.responses, r.failures, r.retries) for r in m.rounds]


def assert_same_metrics(a, b, skip=()):
    """Two runs' ``SimMetrics`` bit for bit: JCTs, rounds, ``summary()`` and
    ``resilience()`` but for the counters named in ``skip``."""
    assert a.jcts == b.jcts
    assert rounds_sig(a) == rounds_sig(b)
    assert a.summary() == b.summary()
    ra, rb = a.resilience(), b.resilience()
    for k in skip:
        ra.pop(k)
        rb.pop(k)
    assert ra == rb


# ---- the training slice: gradients and deltas leaf by leaf, client data

def leaves_close(got, want, rel, what=""):
    """A port tree against a reference tree, leaf by leaf in tree order:
    ``|got - want| <= rel · max|want|``."""
    import jax
    from repro_torch import tree as tree_util
    got_l, want_l = tree_util.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape, (what, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (what, i, err, scale)


def client_batches(vocab, T, B, steps, seed=1, client=17):
    """``examples/fl_multijob_training.py``'s client data: ``steps``
    minibatches of one client's Dirichlet topic mix, stacked on a leading
    axis (NumPy)."""
    from repro_torch.data import SyntheticLM, dirichlet_client_mixes
    mix = dirichlet_client_mixes(256, 8, alpha=0.3, seed=0)[client]
    data = SyntheticLM(vocab=vocab, seq_len=T, seed=seed)
    bs = [data.batch(B, topic_mix=mix, seed=1000 + s) for s in range(steps)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}
