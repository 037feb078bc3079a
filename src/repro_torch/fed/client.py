"""Client-side computation plan: the local SGD update (Fig. 6 steps ③-④).

A Venn-scheduled device receives (global params, its data shard), runs
``local_steps`` steps of SGD, and reports the delta.  One function per
(model, steps) serves every client — devices differ only in data and speed,
which the simulator models; the math is shared.  The reference
(``repro/fed/client.py``) jits a ``lax.scan`` over the steps; here each step
is autograd through ``Model.loss_fn`` and the optimizer's ``SGD.update``, on
the device the parameters lie on.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import tree as tree_util
from ..models.model import Model
from ..train.optimizer import SGD
from ..train.train_step import value_and_grad


def make_local_update(model: Model, *, lr: float = 0.05, momentum: float = 0.0,
                      local_steps: int = 1):
    """Returns ``fn(params, batches) -> (delta, metrics)``.

    ``batches``: a dict of tensors with a leading axis of ``local_steps``
    (one minibatch a step).  ``delta = params_after - params_before`` in f32
    per leaf (the FedAvg update unit); ``metrics`` holds ``loss_first`` and
    ``loss_last`` (f32 scalars on the device).  The caller's ``params`` are
    not modified.
    """
    opt = SGD(lr=lr, momentum=momentum)

    def local_update(params: Any, batches: Dict[str, torch.Tensor]
                     ) -> Tuple[Any, Dict[str, torch.Tensor]]:
        steps = {v.shape[0] for v in batches.values()}
        if steps != {local_steps}:
            raise ValueError(f"local_update: batches need a leading axis of "
                             f"local_steps={local_steps}; got {steps}")
        p, s = params, opt.init(params)
        losses = []
        for i in range(local_steps):
            loss, grads = value_and_grad(model.loss_fn, p,
                                         {k: v[i] for k, v in batches.items()})
            p, s = opt.update(grads, s, p)
            del grads
            losses.append(loss)
        delta = tree_util.map(lambda a, b: a.to(torch.float32)
                              - b.to(torch.float32), p, params)
        return delta, {"loss_first": losses[0], "loss_last": losses[-1]}

    return local_update
