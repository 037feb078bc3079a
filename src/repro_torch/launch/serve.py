"""Batched serving from the command line: prefill + decode with KV caches,
on ``cuda:0``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt 1024 --max-new 32

The reference's flags (``repro/launch/serve.py``), plus ``--device``
(``cpu`` runs the host path; without it a missing card is an error).
Parameters are made from ``--seed`` (no checkpoint is read); the prompt is
seeded NumPy tokens, and for a ``vlm`` config the vision embeddings are
standard-normal draws of the same generator, in bf16.  A two-token warm-up runs before the timed call.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..kernels import flash_attention as flash
from ..models import attention
from ..models.model import build_model
from ..serve.engine import Engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host path")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed), device)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (args.batch, args.prompt),
                                    dtype=np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.vision_seq, cfg.vision_dim))).to(torch.bfloat16)

    eng = Engine(cfg, params, temperature=args.temperature, seed=args.seed,
                 device=device)
    # a warm-up of two tokens first, so that the times below are warm ones
    # (the first call builds the kernel and starts cuBLAS)
    eng.generate(batch, max_new=min(2, args.max_new))
    flash.reset_launches()
    attention.reset_counts()
    gen, stats = eng.generate(batch, max_new=args.max_new)
    print(f"served {cfg.name} on {device}: batch={args.batch} "
          f"prompt={stats.prompt_len} generated={stats.generated}")
    print(f"warm prefill {stats.prefill_s*1e3:.1f} ms; decode "
          f"{stats.decode_s*1e3:.1f} ms -> {stats.tokens_per_s:.1f} tok/s/batch")
    print(f"flash kernel launches {flash.launches}; plain attention calls "
          f"{attention.attention_plain_calls}")
    print(f"flash launches by route: tensor cores {flash.launches_wgmma}, "
          f"FMA {flash.launches_fma}")
    print("sample tokens:", gen[0][:12].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
