"""``Model.block_fns`` of the port against the reference's: on reduced f32
configs of every family, one repetition of each group's period — the train
block's loss and every gradient leaf (``value_and_grad`` under
``checkpoint``), the prefill block's output and caches, the decode block's
output and the caches it writes — equal the reference's block functions,
reached through the ``reference_dist`` fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from torch_parity import leaves_close, reduced_pair
from torch_parity import reference_dist  # noqa: F401  (a fixture)

B, T = 2, 32
# f32 through one period of up to 8 layers (Mamba-2's scan among them), of
# each leaf's largest value: the gradient tests' 1e-4 (the serving tests
# take 2e-4)
TOL = 1e-4
BLOCK_ARCHS = ("llama3.2-1b", "mixtral-8x22b", "mamba2-1.3b",
               "jamba-v0.1-52b", "deepseek-v3-671b", "llama-3.2-vision-11b")


def _draw(rng, shape, scale=0.5):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_block_fns_equal_the_reference(reference_dist, arch, kind):
    jcfg, jmodel, jparams, cfg, model, params = reduced_pair(arch, seed=3)
    rng = np.random.default_rng(11)
    jblocks = jmodel.block_fns(kind, T, B)
    blocks = model.block_fns(kind, T, B)
    assert [(b["name"], b["count"]) for b in blocks] == \
        [(b["name"], b["count"]) for b in jblocks]
    for gi, (blk, jblk) in enumerate(zip(blocks, jblocks)):
        # the group's first repetition of its period, in both packages
        jbp = jax.tree.map(lambda a: a[0], jparams[f"blocks{gi}"])
        bp = tree_util.map(lambda t: t[0].clone(), params[f"blocks{gi}"])
        ab = blk["abstract"]
        assert sorted(ab) == sorted(jblk["abstract"])
        assert tree_util.structure(ab["bp"]) == tree_util.structure(
            tree_util.map(lambda t: t, bp))
        x = _draw(rng, ab["x"].shape)
        if kind == "decode":
            cache = tree_util.map(lambda t: _draw(rng, t.shape, 1.0),
                                  ab["cache"])
            jcache = tree_util.map(jnp.asarray, cache)
            pcache = tree_util.map(lambda a: torch.tensor(a), cache)
            want = jblk["fn"](jbp, jcache, jnp.asarray(x),
                              jnp.asarray(T - 1, jnp.int32))
            got = blk["fn"](bp, pcache, torch.tensor(x), ab["cache_len"])
            assert ab["cache_len"] == T - 1
            leaves_close(got, want, TOL, (arch, kind, gi))
            continue
        args, jargs = [bp, torch.tensor(x)], [jbp, jnp.asarray(x)]
        if "vis" in ab:
            vis = _draw(rng, ab["vis"].shape)
            args.append(torch.tensor(vis))
            jargs.append(jnp.asarray(vis))
        want = jblk["fn"](*jargs)
        got = blk["fn"](*args)
        if kind == "train":
            (value, grads), (jvalue, jgrads) = got, want
            assert abs(float(value) - float(jvalue)) <= 1e-5 * abs(
                float(jvalue)), (arch, gi)
            leaves_close(grads, jgrads, TOL, (arch, kind, gi))
        else:
            leaves_close(got, want, TOL, (arch, kind, gi))
