"""Train-step / serve-step factories on one device: the functions the trainer
and the launchers call.

``make_train_step`` returns ``(train_step, specs)``: loss = token CE (+ MoE
aux), gradients by autograd over the (optionally remat'd) forward, the AdamW
update in the same step (bf16 weights, f32 moments: the reference's memory
picture).  ``make_prefill_step`` / ``make_decode_step`` are the serving
counterparts; decode writes the caches in place.

Gradient accumulation (microbatching): the batch is split on a leading
microbatch axis and walked, trading step latency for activation memory;
gradients are summed in f32 and divided by ``microbatch`` as a tensor (a
division by a Python scalar on the card is a reciprocal multiply, one ulp
off in places).

There is **no runnable reference** for this module: the reference's
``repro/train/train_step.py`` imports ``repro.dist.sharding`` at module top,
and that package is not in the repository.  The port follows its source
text without the mesh and the shardings (one device: the device of the
parameters given), and its tests hold a step against the reference's
runnable parts (``jax.value_and_grad(Model.loss_fn)`` and ``AdamW.update``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import tree as tree_util
from ..configs.base import ModelConfig
from ..models.common import abstract_params
from ..models.model import build_model
from .optimizer import AdamW, AdamWState


def value_and_grad(fn: Callable[..., torch.Tensor], params: Any, *args: Any,
                   **kw: Any) -> Tuple[torch.Tensor, Any]:
    """``(fn(params, *args, **kw), its gradient)`` by autograd: the value
    detached, the gradient a tree of ``params``' structure in each leaf's
    dtype (zeros for a leaf the value does not depend on, as ``jax.grad``
    gives).  ``params`` is not modified."""
    treedef = tree_util.structure(params)
    live = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
    with torch.enable_grad():
        value = fn(tree_util.unflatten(treedef, live), *args, **kw)
    grads = torch.autograd.grad(value, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return value.detach(), tree_util.unflatten(treedef, grads)


def make_train_step(cfg: ModelConfig, *, optimizer: Optional[AdamW] = None,
                    remat: bool = True, microbatch: int = 1):
    """Returns ``(train_step, specs)``: ``train_step(params, opt_state,
    batch) -> (loss, new_params, new_opt_state)`` on the parameters'
    device; ``specs`` holds the abstract (``meta``) parameter and optimizer
    trees."""
    optimizer = optimizer or AdamW()
    model = build_model(cfg)

    def loss_fn(params, batch):
        return model.loss_fn(params, batch, remat=remat)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        if microbatch > 1:
            mbatch = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                                   *v.shape[1:]) for k, v in batch.items()}
            loss, grads = None, None
            for m in range(microbatch):
                l, g = value_and_grad(loss_fn, params,
                                      {k: v[m] for k, v in mbatch.items()})
                g = tree_util.map(lambda t: t.to(torch.float32), g)
                if grads is None:
                    loss, grads = l, g
                else:
                    loss = loss + l
                    grads = tree_util.map(torch.add, grads, g)
                del g
            n = torch.full((), float(microbatch), dtype=torch.float32,
                           device=loss.device)
            loss = loss / n
            grads = tree_util.map(lambda g: g / n, grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return loss, new_params, new_opt

    aparams = model.abstract_params()
    specs = {"abstract_params": aparams,
             "abstract_opt": optimizer.abstract_state(aparams)}
    return train_step, specs


def make_prefill_step(cfg: ModelConfig):
    model = build_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, caches = model.prefill(params, batch)
        return logits, caches

    return prefill_step, {"abstract_params": model.abstract_params()}


def make_decode_step(cfg: ModelConfig, *, cache_batch: int = 1,
                     cache_seq: int = 0):
    """serve_step: one new token against a cache of length ``cache_seq``."""
    model = build_model(cfg)
    cache_specs_tree = model.cache_param_specs(cache_batch, cache_seq)

    @torch.no_grad()
    def decode_step(params, caches, token, cache_len):
        logits, new_caches = model.decode_step(params, caches, token,
                                               cache_len)
        return logits, new_caches

    return decode_step, {
        "abstract_params": model.abstract_params(),
        "abstract_caches": [abstract_params(c) for c in cache_specs_tree],
    }
