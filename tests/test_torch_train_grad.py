"""The port's gradients vs the JAX reference.

* ``FlashAttentionFn`` (the flash wrapper's forward, a plain recompute for
  its backward): dq, dk, dv against ``jax.vjp`` of the reference's
  ``chunked_attention`` for causal, windowed, GQA and query-offset calls,
  within ``1e-5`` of each gradient's largest magnitude;
* ``Model.loss_fn``'s value and gradient against ``jax.value_and_grad`` of
  the reference's ``loss_fn`` on reduced configurations (2 layers, or one
  period of jamba's 8 and llama-vision's 5; vocab 128) at f32, the MoE aux
  loss and the seeded gate, router bias and SSM leaves included: the loss
  within ``1e-5`` relative, each gradient leaf within ``1e-4`` of that
  leaf's largest magnitude;
* ``remat=True`` changes no gradient bit; ``chunked_attention`` builds a
  graph only where a gradient is wanted.

The reference's forwards run through the ``reference_dist`` fixture
(``tests/torch_parity.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jchunked
from repro_torch import tree as tree_util
from repro_torch.kernels import flash_attention as fm
from repro_torch.models import attention
from repro_torch.train.train_step import value_and_grad
from repro_torch.configs import get_config
from torch_parity import (client_batches, kernel_attention_layers,
                          leaves_close, plain_attention_layers, reduced_pair,
                          vision_embeds)
from torch_parity import reference_dist  # noqa: F401  (a fixture)

ARCHS = ("llama3.2-1b", "stablelm-1.6b", "qwen3-32b", "gemma2-27b",
         "mixtral-8x22b", "deepseek-v3-671b", "mamba2-1.3b",
         "jamba-v0.1-52b", "llama-3.2-vision-11b")
B, T, STEPS, LR = 4, 16, 2, 0.15


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Models, parameters and the example's client data: two minibatches of
    a Dirichlet client mix (and, for a vlm, seeded vision embeddings)."""
    layers = max(2, get_config(arch).block_period)
    batches = client_batches(128, T, B, STEPS)
    pair = reduced_pair(arch, n_layers=layers, vocab=128)
    if pair[3].family == "vlm":
        batches["vision_embeds"] = np.stack(
            [vision_embeds(pair[3], B, seed=s) for s in range(STEPS)])
    return pair, batches


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_grad_equals_reference(arch, reference_dist):
    (jcfg, jmodel, jparams, cfg, model, params), batches = _setup(arch)
    batch = {k: v[0] for k, v in batches.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    fm.reset_launches()
    attention.reset_counts()
    loss, grads = value_and_grad(model.loss_fn, params,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    leaves_close(grads, jgrads, 1e-4, arch)
    # one backward an attention layer through FlashAttentionFn, none on the
    # softcap and MLA routes (plain forwards, differentiated by autograd)
    assert fm.backward_plain_calls == kernel_attention_layers(model)
    assert attention.attention_plain_calls == plain_attention_layers(model)
    assert fm.launches == 0                          # the CPU: no kernel


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b"])
def test_remat_changes_no_gradient_bit(arch):
    (_, _, _, cfg, model, params), batches = _setup(arch)
    batch = {k: torch.from_numpy(v[1]) for k, v in batches.items()}
    l0, g0 = value_and_grad(model.loss_fn, params, batch)
    l1, g1 = value_and_grad(functools.partial(model.loss_fn, remat=True),
                            params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_util.leaves(g0), tree_util.leaves(g1)):
        assert torch.equal(a, b)


# (B, T, S, H, Hkv, D, causal, window, q_offset)
FLASH_GRAD_CASES = [
    (2, 24, 24, 4, 4, 16, True, 0, 0),          # causal
    (1, 40, 40, 4, 2, 16, True, 8, 0),          # sliding window, GQA
    (2, 17, 17, 8, 2, 32, False, 0, 0),         # bidirectional, GQA 4:1
    (1, 12, 30, 4, 1, 16, True, 0, 18),         # a query offset (prefill
    (1, 9, 25, 2, 2, 64, True, 12, 16),         # continuation), + window
]


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_attention_fn_grads_equal_reference(case):
    Bq, Tq, S, H, Hkv, D, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case))
    q = rng.standard_normal((Bq, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((Bq, Tq, H, D)).astype(np.float32)
    @jax.jit
    def ref(q, k, v, do):
        out, vjp = jax.vjp(
            lambda a, b, c: jchunked(a, b, c, causal=causal, window=window,
                                     q_offset=q_offset, kv_chunk=16), q, k, v)
        return out, vjp(do)
    out_j, want = ref(q, k, v, do)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    fm.reset_launches()
    out = fm.FlashAttentionFn.apply(*ts, causal, window, q_offset)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    assert fm.backward_plain_calls == 1 and fm.launches == 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (name, err)


def test_chunked_attention_takes_the_fn_only_for_a_gradient():
    """Grad mode on and an input that requires grad: FlashAttentionFn;
    otherwise the wrapper itself (the serving path's call, no graph); the
    softcap route stays a differentiable plain forward."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    with torch.no_grad():
        assert attention.chunked_attention(q, k, v).grad_fn is None
    assert attention.chunked_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = attention.chunked_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert attention.chunked_attention(qg, k, v).grad_fn is None
    attention.reset_counts()
    capped = attention.chunked_attention(qg, k, v, attn_softcap=50.0)
    assert capped.grad_fn is not None
    assert "FlashAttentionFn" not in type(capped.grad_fn).__name__
    assert attention.attention_plain_calls == 1
