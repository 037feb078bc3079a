"""Batched serving engine: prefill → greedy/temperature decode loop.

The counterpart of the reference's ``repro/serve/engine.py``: the engine
allocates decode buffers of length prompt + max_new, seeds them from the
prefill caches (full-attention and MLA latent caches grow; ring, Mamba and
cross-attention caches are fixed-size), and steps ``Model.decode_step``,
which writes each step's cache entries into the buffers in place.  A
``vlm`` batch's ``vision_embeds`` go to the prefill with the tokens.  Prefill's attention goes through the hand-written flash
kernel on the card (:func:`repro_torch.models.attention.chunked_attention`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import tree as tree_util
from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models.model import Model, build_model


def grow_caches(model: Model, caches: List[Any], extra: int) -> List[Any]:
    """Pad full-attention and MLA latent caches along the sequence axis by
    ``extra`` decode slots (stacked leaves: (count, B, S, ...)); ring,
    Mamba and cross-attention caches keep their size."""
    out = []
    for gi, g in enumerate(model.groups):
        cs, new = caches[gi], {}
        for li, desc in enumerate(g.descs):
            c = cs[f"l{li}"]
            if desc.mixer == "attn" and desc.window == 0:
                c = {k: torch.cat([v, v.new_zeros((v.shape[0], v.shape[1],
                                                   extra, *v.shape[3:]))],
                                  dim=2)
                     for k, v in c.items()}
            new[f"l{li}"] = c
        out.append(new)
    return out


@dataclass
class ServeStats:
    prompt_len: int
    generated: int
    prefill_s: float
    decode_s: float

    @property
    def tokens_per_s(self) -> float:
        return self.generated / self.decode_s if self.decode_s > 0 else 0.0


class Engine:
    """``Engine(cfg, params)`` serves on ``cuda:0`` (an error without a
    card) unless given ``device="cpu"``; ``params`` must live there.

    Greedy decoding (``temperature <= 0``) takes the first maximum, as
    ``jnp.argmax`` does, so it matches the reference token for token on
    equal logits.  Temperature sampling draws from a ``torch.Generator``
    seeded with ``seed``: its stream is not ``jax.random``'s, so sampled
    tokens differ from the reference's for the same seed; the distribution
    is the same."""

    def __init__(self, cfg: ModelConfig, params: Any, *,
                 temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        for t in tree_util.leaves(params):
            if t.device != self.device:
                raise ValueError(f"Engine: parameters on {t.device}, the "
                                 f"engine on {self.device}")
        self.params = params
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, batch: Dict[str, Any], max_new: int
                 ) -> Tuple[np.ndarray, ServeStats]:
        """``batch["tokens"]`` ``(B, T)`` (NumPy or tensor; for a ``vlm``
        config also ``batch["vision_embeds"]``) -> generated tokens ``(B,
        max_new)`` as NumPy int32, and the timings."""
        batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                    else v).to(self.device)
                 for k, v in batch.items()}
        B, T = batch["tokens"].shape
        self._sync()
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(self.params, batch)
        caches = grow_caches(self.model, caches, max_new)
        self._sync()
        t1 = time.perf_counter()
        out = []
        tok = self._sample(logits)
        for i in range(max_new):
            out.append(tok)
            logits, caches = self.model.decode_step(self.params, caches, tok,
                                                    T + i)
            tok = self._sample(logits)
        gen = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        self._sync()
        t2 = time.perf_counter()
        return gen, ServeStats(T, max_new, t1 - t0, t2 - t1)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        last = logits[:, -1, :]
        if self.temperature <= 0:
            return torch.argmax(last, dim=-1)[:, None]
        p = torch.softmax(last.to(torch.float32)
                          / torch.full((), self.temperature,
                                       device=last.device), dim=-1)
        return torch.multinomial(p, 1, generator=self.generator)
