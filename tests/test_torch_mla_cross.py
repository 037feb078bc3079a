"""The port's DeepSeek-V3 Multi-head Latent Attention and llama-vision's
gated cross-attention vs the JAX reference.

* ``mla_attention`` (prefill: output and latent cache, at a query offset
  too) against ``repro.models.attention.mla_attention``; ``mla_decode``
  (the absorbed-projection step, the entry written in place at
  ``cache_len``) against ``mla_decode`` and its ``_place_entry``, step by
  step, and against the prefill over the longer sequence; MLA's attention
  takes the plain route (``Dv != D``).
* The cross-attention layer of ``llama-3.2-vision-11b`` (reduced) with a
  seeded, non-zero ``gate_attn`` (its init is 0, which would hide the
  layer): full sequence, prefill with its ``{k, v}`` cache of the vision
  rows, decode against that cache, and the gradient of every leaf, the
  vision embeddings included; the cross-attention takes the flash
  wrapper's route.

Small sizes at f32, the reference's seeded parameters carried across,
inputs from NumPy.  Tolerances: ``2e-4`` forward and prefill, ``5e-4``
decode (the reference tests' own, ``tests/test_models_parity.py``);
gradients within ``1e-4`` of each leaf's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro_torch import tree as tree_util
from repro_torch.kernels import flash_attention as fm
from repro_torch.models import attention, blocks
from repro_torch.train.train_step import value_and_grad
from torch_parity import leaves_close, reduced_pair

MLA_KW = dict(n_heads=4, nope=16, rope_dim=8, v_dim=16, rope_theta=1e4)


def _mla_setup(seed=0):
    """The reduced deepseek's first MLA layer weights in both packages."""
    _, _, jparams, cfg, _, params = reduced_pair("deepseek-v3-671b")
    jw = jattn.MLAWeights(**{k: jparams["blocks0"]["l0"]["attn"][k][0]
                             for k in jattn.MLAWeights._fields})
    w = attention.MLAWeights(**{k: params["blocks0"]["l0"]["attn"][k][0]
                                for k in attention.MLAWeights._fields})
    return jw, w, cfg, np.random.default_rng(seed)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("T,q_offset", [(24, 0), (17, 0), (9, 12)])
def test_mla_attention_equals_reference(T, q_offset):
    jw, w, cfg, rng = _mla_setup(T)
    assert (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
            cfg.v_head_dim) == (4, 16, 8, 16)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    want, jcache = jattn.mla_attention(jnp.asarray(x), jw, q_offset=q_offset,
                                       kv_chunk=8, **MLA_KW)
    attention.reset_counts()
    got, cache = attention.mla_attention(torch.from_numpy(x), w,
                                         q_offset=q_offset, kv_chunk=8,
                                         **MLA_KW)
    assert attention.attention_plain_calls == 1      # Dv != D: plain route
    _close(got, want, 2e-4)
    assert tuple(cache.shape) == jcache.shape == (2, T, 32 + 8)
    _close(cache, jcache, 2e-4)


def test_mla_decode_equals_reference_and_prefill():
    """Prefill 12 tokens into a 16-slot cache, decode 4: outputs equal the
    reference's decode and the prefill over all 16 tokens; the cache the
    port wrote in place equals the reference's one-hot placed cache."""
    T0, steps = 12, 4
    jw, w, cfg, rng = _mla_setup(1)
    x = rng.standard_normal((2, T0 + steps, cfg.d_model)).astype(np.float32)
    full, _ = attention.mla_attention(torch.from_numpy(x), w, **MLA_KW)
    _, jlat = jattn.mla_attention(jnp.asarray(x[:, :T0]), jw, **MLA_KW)
    jcache = jnp.pad(jlat, ((0, 0), (0, steps), (0, 0)))
    _, lat = attention.mla_attention(torch.from_numpy(x[:, :T0]), w,
                                     **MLA_KW)
    cache = torch.cat([lat, lat.new_zeros((2, steps, lat.shape[2]))], dim=1)
    ptr = cache.data_ptr()
    for i in range(steps):
        xt = x[:, T0 + i:T0 + i + 1]
        want, jcache = jattn.mla_decode(jnp.asarray(xt), jw, jcache,
                                        cache_len=jnp.asarray(T0 + i),
                                        **MLA_KW)
        got, cache = attention.mla_decode(torch.from_numpy(xt), w, cache,
                                          cache_len=T0 + i, **MLA_KW)
        assert cache.data_ptr() == ptr
        _close(got, want, 5e-4)
        _close(got, full[:, T0 + i:T0 + i + 1], 5e-4)
        _close(cache, jcache, 5e-4)


def test_mla_decode_outside_the_cache_raises():
    jw, w, cfg, rng = _mla_setup(2)
    x = torch.from_numpy(rng.standard_normal((1, 1, cfg.d_model))
                         .astype(np.float32))
    cache = torch.zeros((1, 4, 40))
    with pytest.raises(ValueError, match="outside the cache"):
        attention.mla_decode(x, w, cache, cache_len=4, **MLA_KW)


# ---------------------------------------------------------- cross-attention

def _cross_setup(seed=0):
    jcfg, jmodel, jparams, cfg, model, params = reduced_pair(
        "llama-3.2-vision-11b")
    i = [d.mixer for d in model.groups[0].descs].index("cross")
    jlp = jax.tree.map(lambda a: a[0], jparams["blocks0"])[f"l{i}"]
    lp = tree_util.map(lambda t: t[0], params["blocks0"])[f"l{i}"]
    assert float(jnp.abs(jlp["attn"]["gate_attn"]).min()) > 0.05
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    vis = rng.standard_normal((2, cfg.vision_seq, cfg.d_model)).astype(
        np.float32)
    return (jcfg, jmodel.groups[0].descs[i], jlp, cfg,
            model.groups[0].descs[i], lp, x, vis)


def test_cross_attention_layer_equals_reference():
    jcfg, jdesc, jlp, cfg, desc, lp, x, vis = _cross_setup()
    assert desc.mixer == "cross" and not desc.causal
    want, _ = jblocks.apply_layer(jlp, jnp.asarray(x), jdesc, jcfg,
                                  vis=jnp.asarray(vis))
    attention.reset_counts()
    fm.reset_launches()
    got, _ = blocks.apply_layer(lp, torch.from_numpy(x), desc, cfg,
                                vis=torch.from_numpy(vis))
    _close(got, want, 2e-4)
    # the flash wrapper's route (its plain version on the CPU)
    assert attention.attention_plain_calls == 0 and fm.launches == 0
    # the gate matters: at gate 0 the layer is its MLP alone
    lp0 = dict(lp, attn=dict(lp["attn"],
                             gate_attn=torch.zeros_like(lp["attn"]["gate_attn"])))
    off, _ = blocks.apply_layer(lp0, torch.from_numpy(x), desc, cfg,
                                vis=torch.from_numpy(vis))
    assert float((off - got).abs().max()) > 1e-2


def test_cross_attention_prefill_and_decode_equal_reference():
    """The prefill's cache is the k-normed keys and the values of every
    vision row; three decode steps attend to all of them."""
    jcfg, jdesc, jlp, cfg, desc, lp, x, vis = _cross_setup(1)
    want, jcache = jblocks.apply_layer_prefill(jlp, jnp.asarray(x), jdesc,
                                               jcfg, vis=jnp.asarray(vis))
    got, cache = blocks.apply_layer_prefill(lp, torch.from_numpy(x), desc,
                                            cfg, vis=torch.from_numpy(vis))
    _close(got, want, 2e-4)
    assert sorted(cache) == ["k", "v"]
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape == (
            2, cfg.vision_seq, cfg.n_kv_heads, cfg.head_dim)
        _close(cache[k], jcache[k], 2e-4)
    rng = np.random.default_rng(5)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jblocks.apply_layer_decode(
            jlp, jnp.asarray(xt), jdesc, jcfg, jcache,
            jnp.asarray(20 + step, jnp.int32))
        got, cache = blocks.apply_layer_decode(lp, torch.from_numpy(xt), desc,
                                               cfg, cache, 20 + step)
        _close(got, want, 5e-4)


def test_cross_attention_gradient_equals_reference():
    """``mean(layer(x, vis)²)``: every leaf of the layer (the gate, q/k
    norms, the projections, the MLP) and the gradients of ``x`` and
    ``vis``."""
    jcfg, jdesc, jlp, cfg, desc, lp, x, vis = _cross_setup(2)

    def jloss(jlp, x, vis):
        y, _ = jblocks.apply_layer(jlp, x, jdesc, jcfg, vis=vis)
        return jnp.mean(y ** 2)

    def loss(t):
        y, _ = blocks.apply_layer(t["lp"], t["x"], desc, cfg, vis=t["vis"])
        return torch.mean(y ** 2)
    jval, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jlp, jnp.asarray(x), jnp.asarray(vis))
    fm.reset_launches()
    val, g = value_and_grad(loss, {"lp": lp, "x": torch.from_numpy(x),
                                   "vis": torch.from_numpy(vis)})
    assert fm.backward_plain_calls == 1        # through FlashAttentionFn
    assert float(val) == pytest.approx(float(jval), rel=1e-5)
    leaves_close(g["lp"], jg[0], 1e-4, "layer")
    leaves_close([g["x"], g["vis"]], [jg[1], jg[2]], 1e-4, "inputs")
