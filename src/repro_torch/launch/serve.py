"""Serving driver: a reduced config of ``--arch`` with fresh weights
serves ``--requests`` random prompts through ``serve.ServeEngine`` and
prints the routes' SLO summary.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2-2.7b --device cpu

``--arch`` names any config of the attention-only, MoE (olmoe-1b-7b), MLA
(deepseek-v2-lite-16b), SSM (rwkv6-1.6b) and hybrid (zamba2-2.7b)
families: every decoder of the zoo.

``--device`` defaults to the card and raises where there is none.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.configs.platform import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    dev = resolve_device(args.device)
    cfg = reduce_for_smoke(get_config(args.arch))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = build_model(cfg, device=dev, generator=gen)
    eng = ServeEngine(model, batch_slots=args.slots, max_len=128,
                      temperature=args.temperature, device=dev)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, 4).tolist(),
            max_new_tokens=args.max_new, route="default"))
    ticks = eng.run_until_drained()
    print(json.dumps({
        "arch": args.arch, "device": str(dev), "served": len(eng.done),
        "ticks": ticks, "stats": eng.stats_summary(),
    }, indent=1))


if __name__ == "__main__":
    main()
