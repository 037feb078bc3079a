"""Batched serving example: prefill + KV-cache decode on three model families
(full attention, sliding window + MoE, attention-free SSM), each at its
reduced size in bf16: on the card the prefill's attention (head_dim 16) runs
in the tensor-core flash kernel.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
import argparse

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.model import build_model
from ..serve.engine import Engine

ARCHS = ("llama3.2-1b", "mixtral-8x22b", "mamba2-1.3b")


def seeded_params(arch, model, device):
    return model.init_params(torch.Generator(device=device).manual_seed(0),
                             device)


def main(argv=None, init_params=seeded_params):
    """``init_params(arch, model, device)`` makes each model's parameters
    (seeded 0 by default)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host path")
    dev = resolve_device(ap.parse_args(argv).device)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = init_params(arch, model, dev)
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, 24)).astype(
            np.int32)}
        eng = Engine(cfg, params, temperature=0.0, device=dev)
        gen, stats = eng.generate(batch, max_new=12)
        print(f"{arch:16s} prefill {stats.prefill_s*1e3:7.1f} ms | "
              f"decode {stats.tokens_per_s:7.1f} tok/s | "
              f"first tokens {gen[0][:6].tolist()}")
    print("\nOK — same decode_step the dry-run traces for one H100.")


if __name__ == "__main__":
    main()
