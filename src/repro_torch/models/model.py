"""Model: embeds + stacked block groups + head, with the full-sequence,
prefill and decode entry points the server and the trainer share.

``param_specs`` declares the same tree as the JAX reference
(``repro/models/model.py``): the same keys, shapes, dtypes, logical axes and
init rules, so one configuration counts the same parameters in both
packages and a parameter tree carries across (:mod:`.convert`).
``init_params`` materialises it on a device.

Entry points (functions of parameter trees, as in the reference):

* ``forward(params, batch, *, remat=False)`` — full-sequence logits (and
  MoE aux)
* ``loss_fn(params, batch, *, remat=False)`` — token cross-entropy, the
  trainer's and the FL client's loss; differentiable by autograd
* ``prefill(params, batch)``     — last-position logits + decode caches
* ``decode_step(params, caches, token, cache_len)``
* ``block_fns(kind, seq_len, global_batch, *, remat=True)`` — one
  repetition of each group's layers alone, for the dry-run's roofline

A group's layers are stacked on a leading ``count`` axis, as the reference
scans them; here a Python loop walks the layers, taking each layer's
parameters (and cache) as views of the stacked tensors: a group's leaves
are taken apart once with ``torch.unbind``, so that the gradient of a
stacked leaf is put together by one stack of its layers' gradients (an
indexed view per layer would add a zero tensor of the whole stack into it
once a layer).  ``remat=True`` recomputes each layer's forward in the
backward (``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint``); it changes no value and no gradient bit.  Caches keep the
reference's tree — one dict a group, stacked leaves ``(count, B, S, Hkv,
D)`` — so they compare leaf by leaf; ``decode_step`` writes into them in
place.  Every family runs (:mod:`.blocks`); a ``vlm`` batch carries
``vision_embeds`` ``(B, vision_seq, vision_dim)``, projected once by
``vision_proj`` for the cross-attention layers.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree as tree_util
from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from .blocks import (BlockGroup, apply_layer, apply_layer_decode,
                     apply_layer_prefill, block_groups, cache_specs,
                     layer_specs)
from .common import (abstract_params, count_params, is_spec, layer_norm,
                     materialize, rms_norm, softcap, spec, stack_specs)


def _layers(tree: Any, count: int) -> List[Any]:
    """The ``count`` layer slices (views) of a tree of stacked tensors, each
    leaf taken apart by one ``torch.unbind`` (whose gradient is one
    stack)."""
    split = [torch.unbind(t, 0) for t in tree_util.leaves(tree)]
    treedef = tree_util.structure(tree)
    return [tree_util.unflatten(treedef, [s[c] for s in split])
            for c in range(count)]


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.groups: List[BlockGroup] = block_groups(cfg)
        n = sum(g.count * len(g.descs) for g in self.groups)
        if n != cfg.n_layers:
            raise ValueError(f"{cfg.name}: block groups hold {n} layers, "
                             f"config says {cfg.n_layers}")

    # ------------------------------------------------------------ params

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        specs: Dict[str, Any] = {}
        if cfg.family == "audio":
            specs["frontend"] = {
                "w": spec((cfg.frontend_dim, cfg.d_model), (None, "embed")),
                "b": spec((cfg.d_model,), ("embed",), init="zeros"),
            }
        else:
            specs["embed"] = spec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                                  scale=cfg.d_model ** -0.5)
        if cfg.family == "vlm":
            specs["vision_proj"] = spec((cfg.vision_dim, cfg.d_model),
                                        (None, "embed"))
        for gi, g in enumerate(self.groups):
            block = {f"l{i}": layer_specs(d, cfg) for i, d in enumerate(g.descs)}
            specs[f"blocks{gi}"] = stack_specs(block, g.count)
        specs["ln_f"] = ({"g": spec((cfg.d_model,), ("embed",), init="ones"),
                          "b": spec((cfg.d_model,), ("embed",), init="zeros")}
                         if cfg.norm == "layernorm" else
                         {"g": spec((cfg.d_model,), ("embed",),
                                    init="zeros" if cfg.rms_plus_one else "ones")})
        if not cfg.tie_embeddings:
            specs["head"] = spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        return specs

    def init_params(self, generator: torch.Generator,
                    device: DeviceLike = None) -> Any:
        """Materialised parameters on ``device`` (``None``: ``cuda:0``, or
        an error without one); ``generator`` must live on that device."""
        return materialize(self.param_specs(), generator,
                           resolve_device(device))

    def abstract_params(self) -> Any:
        """The parameter tree as ``meta`` tensors (shapes and dtypes)."""
        return abstract_params(self.param_specs())

    def n_params(self) -> int:
        return count_params(self.param_specs())

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top_k of routed experts)."""
        cfg = self.cfg
        total = 0
        for leaf_path, s in _iter_with_path(self.param_specs()):
            n = 1
            for d in s.shape:
                n *= d
            if "moe" in leaf_path and any(k in leaf_path for k in
                                          ("w_gate", "w_up", "w_down")):
                n = n * cfg.top_k // max(cfg.n_experts, 1)
            total += n
        return total

    # ------------------------------------------------------------ forward

    def _embed(self, params, batch):
        cfg = self.cfg
        if cfg.family == "audio":
            x = batch["frames"].to(params["frontend"]["w"].dtype)
            x = x @ params["frontend"]["w"] + params["frontend"]["b"]
        else:
            x = params["embed"][batch["tokens"].long()]
            if cfg.rms_plus_one:                      # gemma-style embed scale
                x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                                   device=x.device)
        return x

    def _head(self, params, x):
        cfg = self.cfg
        if cfg.norm == "layernorm":
            x = layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"],
                           cfg.norm_eps)
        else:
            x = rms_norm(x, params["ln_f"]["g"], cfg.norm_eps,
                         plus_one=cfg.rms_plus_one)
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        return softcap(x @ w, cfg.logit_softcap)

    def _vision(self, params, batch, x):
        """The vision embeddings projected to d_model (``vlm`` only)."""
        if self.cfg.family != "vlm":
            return None
        return batch["vision_embeds"].to(x.dtype) @ params["vision_proj"]

    def _period(self, g: BlockGroup, lp, x, aux, vis):
        """One repetition of a group's period of layers."""
        for i, desc in enumerate(g.descs):
            x, a = apply_layer(lp[f"l{i}"], x, desc, self.cfg, vis=vis)
            aux = aux + a
        return x, aux

    def forward(self, params, batch, *, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits.  Returns (logits, aux_loss)."""
        x = self._embed(params, batch)
        vis = self._vision(params, batch, x)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, g in enumerate(self.groups):
            for lp in _layers(params[f"blocks{gi}"], g.count):
                if remat:
                    x, aux_total = checkpoint(self._period, g, lp, x,
                                              aux_total, vis,
                                              use_reentrant=False)
                else:
                    x, aux_total = self._period(g, lp, x, aux_total, vis)
        return self._head(params, x), aux_total

    def loss_fn(self, params, batch, *, remat: bool = False) -> torch.Tensor:
        """Mean token cross-entropy (+ 0.01 · aux) in f32."""
        logits, aux = self.forward(params, batch, remat=remat)
        logits32 = logits.to(torch.float32)
        lse = torch.logsumexp(logits32, dim=-1)
        gold = torch.gather(logits32, -1,
                            batch["labels"].long()[..., None])[..., 0]
        return (lse - gold).mean() + 0.01 * aux

    # ------------------------------------------------------------ serving

    def prefill(self, params, batch) -> Tuple[torch.Tensor, List[Any]]:
        """Returns (last-position logits, caches: one stacked tree/group)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        vis = self._vision(params, batch, x)
        caches: List[Any] = []
        for gi, g in enumerate(self.groups):
            per_layer = []
            for lp in _layers(params[f"blocks{gi}"], g.count):
                cs = {}
                for i, desc in enumerate(g.descs):
                    x, cs[f"l{i}"] = apply_layer_prefill(lp[f"l{i}"], x, desc,
                                                         cfg, vis=vis)
                per_layer.append(cs)
            caches.append(tree_util.map(lambda *ts: torch.stack(ts),
                                        *per_layer))
            del per_layer
        logits = self._head(params, x[:, -1:, :])
        return logits, caches

    def decode_step(self, params, caches, token, cache_len: int
                    ) -> Tuple[torch.Tensor, List[Any]]:
        """One decode step.  token: (B, 1) integer; cache_len: int.  The
        caches are updated in place and returned."""
        cfg = self.cfg
        x = self._embed(params, {"tokens": token})
        for gi, g in enumerate(self.groups):
            for lp, lc in zip(_layers(params[f"blocks{gi}"], g.count),
                              _layers(caches[gi], g.count)):
                for i, desc in enumerate(g.descs):
                    x, _ = apply_layer_decode(lp[f"l{i}"], x, desc, cfg,
                                              lc[f"l{i}"], cache_len)
        return self._head(params, x), caches

    # -------------------------------------------------------------- specs

    def cache_param_specs(self, batch: int, seq: int) -> List[Any]:
        """ParamSpec tree of decode caches (stacked per group)."""
        out = []
        for g in self.groups:
            block = {f"l{i}": cache_specs(d, self.cfg, batch, seq)
                     for i, d in enumerate(g.descs)}
            out.append(stack_specs(block, g.count))
        return out

    def input_specs(self, seq_len: int, global_batch: int, kind: str
                    ) -> Dict[str, Any]:
        """``meta`` tensors for the chosen entry point's inputs (the
        reference's ShapeDtypeStructs: shapes and dtypes, no storage)."""
        cfg = self.cfg
        B, T = global_batch, seq_len

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        ii, bf = torch.int32, torch.bfloat16
        if kind in ("train", "prefill"):
            if cfg.family == "audio":
                batch = {"frames": meta((B, T, cfg.frontend_dim), bf)}
            else:
                batch = {"tokens": meta((B, T), ii)}
            if kind == "train":
                batch["labels"] = meta((B, T), ii)
            if cfg.family == "vlm":
                batch["vision_embeds"] = meta(
                    (B, cfg.vision_seq, cfg.vision_dim), bf)
            return batch
        if kind == "decode":
            caches = [abstract_params(c) for c in self.cache_param_specs(B, T)]
            return {"token": meta((B, 1), ii), "cache_len": meta((), ii),
                    "caches": caches}
        raise ValueError(kind)

    # ----------------------------------------------- roofline block programs

    def block_fns(self, kind: str, seq_len: int, global_batch: int,
                  *, remat: bool = True) -> List[Dict[str, Any]]:
        """One entry per block group: ``{fn, abstract, count, name,
        block_spec}``, ``fn`` one repetition of the group's period of layers
        and ``abstract`` its arguments as ``meta`` tensors (the reference's
        ``Model.block_fns``).  The kinds:

        * ``train``: ``fn(bp, x, vis=None)`` is ``value_and_grad`` of
          ``mean(x.float()**2) + 0.01·aux`` over the period, with respect to
          ``(bp, x)``, under ``torch.utils.checkpoint`` when ``remat``;
        * ``prefill``: ``fn(bp, x, vis=None) -> (x, caches)``;
        * ``decode``: ``fn(bp, cache, x, cache_len) -> (x, caches)``, the
          caches written in place; ``abstract["cache_len"]`` is the int
          ``seq_len - 1`` (a full cache: decode reads all of it whatever its
          length) and ``abstract["cache_spec"]`` the cache's spec tree.

        The dry-run traces each alone (:mod:`repro_torch.launch.dryrun`)."""
        from ..train.train_step import value_and_grad
        cfg = self.cfg
        B, T = global_batch, seq_len

        def meta(shape, dtype=torch.bfloat16):
            return torch.empty(shape, dtype=dtype, device="meta")
        x_t = meta((B, T, cfg.d_model))
        vis_t = (meta((B, cfg.vision_seq, cfg.d_model))
                 if cfg.family == "vlm" else None)
        out: List[Dict[str, Any]] = []
        for gi, g in enumerate(self.groups):
            block_spec = {f"l{i}": layer_specs(d, cfg)
                          for i, d in enumerate(g.descs)}
            abstract: Dict[str, Any] = {"bp": abstract_params(block_spec)}
            if kind == "train":
                def fn(bp, x, vis=None, g=g):
                    def inner(args):
                        bp, x = args
                        aux = torch.zeros((), dtype=torch.float32,
                                          device=x.device)
                        x, aux = self._period(g, bp, x, aux, vis)
                        return torch.mean(x.to(torch.float32) ** 2) \
                            + 0.01 * aux
                    if remat:
                        return value_and_grad(
                            lambda a: checkpoint(inner, a,
                                                 use_reentrant=False),
                            (bp, x))
                    return value_and_grad(inner, (bp, x))
            elif kind == "prefill":
                @torch.no_grad()
                def fn(bp, x, vis=None, g=g):
                    cs = {}
                    for i, desc in enumerate(g.descs):
                        x, cs[f"l{i}"] = apply_layer_prefill(
                            bp[f"l{i}"], x, desc, cfg, vis=vis)
                    return x, cs
            elif kind == "decode":
                cache_spec = {f"l{i}": cache_specs(d, cfg, B, T)
                              for i, d in enumerate(g.descs)}

                @torch.no_grad()
                def fn(bp, cache, x, cache_len, g=g):
                    ncs = {}
                    for i, desc in enumerate(g.descs):
                        x, ncs[f"l{i}"] = apply_layer_decode(
                            bp[f"l{i}"], x, desc, cfg, cache[f"l{i}"],
                            cache_len)
                    return x, ncs
                abstract.update(cache=abstract_params(cache_spec),
                                x=meta((B, 1, cfg.d_model)),
                                cache_len=T - 1, cache_spec=cache_spec)
            else:
                raise ValueError(kind)
            if kind != "decode":
                abstract["x"] = x_t
                if vis_t is not None:
                    abstract["vis"] = vis_t
            out.append({"fn": fn, "abstract": abstract, "count": g.count,
                        "name": f"group{gi}", "block_spec": block_spec})
        return out


def _iter_with_path(tree, prefix=""):
    if is_spec(tree):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_with_path(v, prefix + "/" + str(k))


@functools.lru_cache(maxsize=64)
def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
