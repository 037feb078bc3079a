"""The port's model layers vs the JAX reference: norms, RoPE, softcap,
activations, the feed-forward blocks, and one layer of every distinct kind
in every registered configuration (GQA and MLA attention, cross-attention,
Mamba-2; MLP and MoE) — full sequence (``apply_layer``), prefill with its
cache (``apply_layer_prefill``) and decode steps (``apply_layer_decode``).

Reduced configurations at f32, the reference's seeded parameters carried
across with ``params_from_jax``; inputs from NumPy.  Tolerances: ``1e-6`` for
the elementwise layers (one f32 rounding or a transcendental's ulp apart);
``1e-5`` for the FFN and a whole layer (f32 products of width 64-128 summed
in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.kernels import ref as kref
from repro_torch.models import blocks, build_model, common, ffn
from torch_parity import FORWARD_ARCHS, reduced_pair


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy() if torch.is_tensor(got)
                               else np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


RNG = np.random.default_rng(13)


# ------------------------------------------------------------ elementwise

@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_equals_reference(plus_one, dtype):
    x = RNG.standard_normal((3, 5, 64)).astype(np.float32) * 3
    g = RNG.standard_normal(64).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jcommon.rms_norm(jnp.asarray(x, jdt), jnp.asarray(g, jdt), 1e-6,
                            plus_one=plus_one)
    got = common.rms_norm(_t(x).to(tdt), _t(g).to(tdt), 1e-6,
                          plus_one=plus_one)
    assert got.dtype == tdt
    _close(got, want, 1e-6 if dtype == "float32" else 2e-2)


def test_layer_norm_equals_reference():
    x = RNG.standard_normal((2, 7, 48)).astype(np.float32) + 2.0
    g, b = RNG.standard_normal((2, 48)).astype(np.float32)
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                              1e-5)
    _close(common.layer_norm(_t(x), _t(g), _t(b), 1e-5), want, 1e-6)


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (64, 5e5), (4, 1e6)])
def test_rope_freqs_equal_reference(head_dim, theta):
    _close(common.rope_freqs(head_dim, theta),
           jcommon.rope_freqs(head_dim, theta), 1e-7)


@pytest.mark.parametrize("rotary_dim", [None, 4, 8])
@pytest.mark.parametrize("theta", [1e4, 5e5])
@pytest.mark.parametrize("offset,T", [(0, 40), (37, 1)])
def test_apply_rope_equals_reference(rotary_dim, theta, offset, T):
    """Full and partial rotary (stablelm's 25 %), prefill positions and a
    decode position."""
    x = RNG.standard_normal((2, T, 4, 16)).astype(np.float32)
    pos = (offset + np.arange(T))[None, :]
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                              rotary_dim=rotary_dim)
    got = common.apply_rope(_t(x), torch.from_numpy(pos), theta,
                            rotary_dim=rotary_dim)
    _close(got, want, 2e-6)


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap_equals_reference(cap):
    x = RNG.standard_normal((4, 100)).astype(np.float32) * 60
    _close(common.softcap(_t(x), cap), jcommon.softcap(jnp.asarray(x), cap),
           1e-6)


class _Divisions(TorchFunctionMode):
    """Records the divisor of every tensor division run under it."""

    FUNCS = {torch.div, torch.true_divide, torch.Tensor.div,
             torch.Tensor.div_, torch.Tensor.__truediv__,
             torch.Tensor.__itruediv__}

    def __init__(self):
        super().__init__()
        self.divisors = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.FUNCS:
            self.divisors.append(args[1] if len(args) > 1
                                 else kwargs["other"])
        return func(*args, **kwargs)


_X = torch.from_numpy(RNG.standard_normal((2, 8, 4, 16)).astype(np.float32))

DIVIDING = {
    "softcap": lambda: common.softcap(_X * 60, 50.0),
    "rope_freqs": lambda: common.rope_freqs(16, 1e4),
    "apply_rope": lambda: common.apply_rope(_X, torch.arange(8)[None, :]),
    "flash_attention_ref": lambda: kref.flash_attention_ref(_X, _X[:, :, :2],
                                                            _X[:, :, :2]),
}


@pytest.mark.parametrize("name", sorted(DIVIDING))
def test_plain_paths_divide_by_tensors(name):
    """On the card torch turns ``x / python_float`` into a multiply by the
    reciprocal (one ulp off a true division in places); the CPU divides
    truly either way, so the form itself is pinned here: every division
    in these plain paths has a tensor divisor."""
    with _Divisions() as rec:
        DIVIDING[name]()
    assert rec.divisors, f"{name}: no division seen"
    for d in rec.divisors:
        assert isinstance(d, torch.Tensor), (name, type(d))


def test_softcap_is_the_true_division():
    """Where ``x · (1/cap)`` and ``x / cap`` differ in f32, softcap takes
    the quotient."""
    cap = np.float32(30.0)
    x = (RNG.standard_normal(20000) * 100).astype(np.float32)
    true_q = x / cap
    recip_q = x * (np.float32(1.0) / cap)
    differ = true_q != recip_q
    assert differ.any()
    want = torch.tensor(cap) * torch.tanh(torch.from_numpy(true_q))
    got = common.softcap(torch.from_numpy(x), float(cap))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations_equal_reference(name):
    x = RNG.standard_normal(1000).astype(np.float32) * 4
    _close(common.ACTIVATIONS[name](_t(x)),
           jcommon.ACTIVATIONS[name](jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_equals_reference(act):
    p = {"w_gate": RNG.standard_normal((64, 128)) / 8,
         "w_up": RNG.standard_normal((64, 128)) / 8,
         "w_down": RNG.standard_normal((128, 64)) / 11}
    x = RNG.standard_normal((2, 9, 64))
    want = jffn.gated_mlp({k: jnp.asarray(v, jnp.float32)
                           for k, v in p.items()},
                          jnp.asarray(x, jnp.float32), act)
    _close(ffn.gated_mlp({k: _t(v) for k, v in p.items()}, _t(x), act),
           want, 1e-5)


def test_mlp_equals_reference():
    p = {"w_in": RNG.standard_normal((64, 128)) / 8,
         "b_in": RNG.standard_normal(128),
         "w_out": RNG.standard_normal((128, 64)) / 11,
         "b_out": RNG.standard_normal(64)}
    x = RNG.standard_normal((2, 9, 64))
    want = jffn.mlp({k: jnp.asarray(v, jnp.float32) for k, v in p.items()},
                    jnp.asarray(x, jnp.float32), "gelu")
    _close(ffn.mlp({k: _t(v) for k, v in p.items()}, _t(x), "gelu"), want,
           1e-5)


# ------------------------------------------------------------ one layer

def _kinds(arch):
    """(group, index in the period) of the first layer of each distinct
    descriptor of ``arch``, in model order."""
    out, seen = [], set()
    for gi, g in enumerate(build_model(get_config(arch).reduced()).groups):
        for i, d in enumerate(g.descs):
            if d not in seen:
                seen.add(d)
                out.append((gi, i))
    return out


LAYER_CASES = [(a, li) for a in FORWARD_ARCHS
               for li in range(len(_kinds(a)))]
T = 40          # gemma2's reduced window is 32: its ring wraps

_pair = functools.lru_cache(maxsize=None)(reduced_pair)


def _layer_setup(arch, li):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch)
    gi, i = _kinds(arch)[li]
    jlp = jax.tree.map(lambda a: a[0], jparams[f"blocks{gi}"])[f"l{i}"]
    lp = tree_util.map(lambda t: t[0], params[f"blocks{gi}"])[f"l{i}"]
    jdesc, desc = jmodel.groups[gi].descs[i], model.groups[gi].descs[i]
    assert jdesc.__dict__ == desc.__dict__
    x = RNG.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    # a cross-attention layer's projected vision embeddings
    vis = (RNG.standard_normal((2, cfg.vision_seq, cfg.d_model))
           .astype(np.float32) if desc.mixer == "cross" else None)
    return jcfg, jlp, jdesc, cfg, lp, desc, x, vis


def _vis(vis, jax_side):
    if vis is None:
        return None
    return jnp.asarray(vis) if jax_side else _t(vis)


# the decode cache of each mixer
CACHE_KEYS = {"attn": ["k", "v"], "mla": ["lat"], "cross": ["k", "v"],
              "mamba": ["cb", "cc", "cx", "ssm"]}


def _cache_kind(desc, cfg):
    return "mla" if desc.mixer == "attn" and cfg.use_mla else desc.mixer


@pytest.mark.parametrize("arch,li", LAYER_CASES)
def test_apply_layer_equals_reference(arch, li):
    jcfg, jlp, jdesc, cfg, lp, desc, x, vis = _layer_setup(arch, li)
    want, jaux = jblocks.apply_layer(jlp, jnp.asarray(x), jdesc, jcfg,
                                     vis=_vis(vis, True))
    got, aux = blocks.apply_layer(lp, _t(x), desc, cfg, vis=_vis(vis, False))
    _close(got, want, 1e-5)
    if desc.ffn == "moe":        # the Switch aux loss: positive, equal
        assert float(jaux) > 0
        assert abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)
    else:
        assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch,li", LAYER_CASES)
def test_apply_layer_prefill_equals_reference(arch, li):
    jcfg, jlp, jdesc, cfg, lp, desc, x, vis = _layer_setup(arch, li)
    want, jcache = jblocks.apply_layer_prefill(jlp, jnp.asarray(x), jdesc,
                                               jcfg, vis=_vis(vis, True))
    got, cache = blocks.apply_layer_prefill(lp, _t(x), desc, cfg,
                                            vis=_vis(vis, False))
    _close(got, want, 1e-5)
    assert sorted(cache) == sorted(jcache) == CACHE_KEYS[_cache_kind(desc,
                                                                     cfg)]
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
        _close(cache[name], jcache[name], 1e-5)
    # the full-sequence layer computes the same output
    _close(blocks.apply_layer(lp, _t(x), desc, cfg, vis=_vis(vis, False))[0],
           got, 1e-6)


DECODE_LAYER_CASES = [c for c in LAYER_CASES if c[0] != "hubert-xlarge"]


def _grow(cache, jcache, kind, window):
    """Two decode slots more on a full-length KV or MLA latent cache (axis
    1); ring, cross-attention and Mamba caches keep their size."""
    if kind not in ("attn", "mla") or window:
        return cache, jcache
    jcache = {k: jnp.pad(v, [(0, 0), (0, 2)] + [(0, 0)] * (v.ndim - 2))
              for k, v in jcache.items()}
    cache = {k: torch.cat([v, v.new_zeros((v.shape[0], 2, *v.shape[2:]))],
                          dim=1) for k, v in cache.items()}
    return cache, jcache


@pytest.mark.parametrize("arch,li", DECODE_LAYER_CASES)
def test_apply_layer_decode_equals_reference(arch, li):
    """Two decode steps after a prefill of ``T`` tokens: outputs and the
    cache written in place equal the reference's new arrays."""
    jcfg, jlp, jdesc, cfg, lp, desc, x, vis = _layer_setup(arch, li)
    _, jcache = jblocks.apply_layer_prefill(jlp, jnp.asarray(x), jdesc, jcfg,
                                            vis=_vis(vis, True))
    _, cache = blocks.apply_layer_prefill(lp, _t(x), desc, cfg,
                                          vis=_vis(vis, False))
    cache, jcache = _grow(cache, jcache, _cache_kind(desc, cfg), desc.window)
    for step in range(2):
        xt = RNG.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jblocks.apply_layer_decode(
            jlp, jnp.asarray(xt), jdesc, jcfg, jcache,
            jnp.asarray(T + step, jnp.int32))
        before = {k: v.data_ptr() for k, v in cache.items()}
        got, cache = blocks.apply_layer_decode(lp, _t(xt), desc, cfg, cache,
                                               T + step)
        assert {k: v.data_ptr() for k, v in cache.items()} == before
        _close(got, want, 1e-5)
        assert sorted(cache) == sorted(jcache)
        for name in cache:
            _close(cache[name], jcache[name], 1e-5)


def test_decode_outside_the_cache_raises():
    jcfg, jlp, jdesc, cfg, lp, desc, x, vis = _layer_setup("llama3.2-1b", 0)
    _, cache = blocks.apply_layer_prefill(lp, _t(x), desc, cfg)
    with pytest.raises(ValueError, match="outside the cache"):
        blocks.apply_layer_decode(lp, _t(x[:, :1]), desc, cfg, cache, T)
