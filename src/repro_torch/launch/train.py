"""Training driver: a reduced config of ``--arch`` with fresh weights
trains on the synthetic corpus through ``train.Trainer``; it prints a
JSON summary as its last line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu

``--device`` defaults to the card and raises where there is none.
``--die-at-step N`` hard-exits with code 42 before step N (fault
injection); a rerun with the same ``--ckpt-dir`` resumes from the last
committed step. As in the JAX driver, the rerun reads the corpus again
from its first batch.

For an encoder-decoder (``--arch whisper-large-v3``) each batch gains
``frames`` [batch, 16, d_model], float32 on the device, drawn once per
batch from a ``torch.Generator`` seeded with the batch's first token (the
JAX launcher folds that token into ``PRNGKey(0)``: the same keying, not
the same bits).
"""
from __future__ import annotations

import argparse
import json
import os


ENC_FRAMES = 16      # the stub frontend's frames per training example


def with_frames(batches, batch: int, d_model: int, device):
    """Each batch of ``batches`` with ``frames`` [batch, ENC_FRAMES,
    d_model] added, float32 on ``device``, from a generator seeded with
    the batch's first token."""
    import torch

    for b in batches:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(b["tokens"][0, 0]))
        frames = torch.randn((batch, ENC_FRAMES, d_model), generator=gen,
                             dtype=torch.float32, device=device)
        yield {"frames": frames, "tokens": b["tokens"],
               "targets": b["targets"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--clip", default="quantile",
                    choices=["quantile", "global"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--die-at-step", type=int, default=None,
                    help="fault injection: hard-exit mid-run (tests)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.configs.platform import resolve_device
    from repro_torch.core import rng as crng
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import Optimizer, warmup_cosine
    from repro_torch.train import create_train_state, make_train_step
    from repro_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    cfg = reduce_for_smoke(get_config(args.arch))
    cfg = dataclasses.replace(cfg, max_seq_len=max(cfg.max_seq_len, args.seq))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=gen)
    opt = Optimizer(kind="adamw",
                    lr_fn=warmup_cosine(args.lr, 10, args.steps))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=args.seq,
                                        batch_size=args.batch,
                                        seed=args.seed))
    example = next(corpus.iterate(prefetch=0, device=dev))
    data_iter = corpus.iterate(device=dev)
    if cfg.is_encdec:
        example = next(with_frames([example], args.batch, cfg.d_model, dev))
        data_iter = with_frames(data_iter, args.batch, cfg.d_model, dev)
    state = create_train_state(model, opt, crng.prng_key(args.seed),
                               example_batch=example)
    step_fn = make_train_step(model, opt, clip_mode=args.clip)
    trainer = Trainer(model, opt, step_fn, data_iter,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    state = trainer.restore_or_init(state)

    if args.die_at_step is not None:
        # fault injection: run until the poison step, then hard-exit
        for i in range(int(state.step), args.steps):
            if i >= args.die_at_step:
                print(f"[fault-injection] dying at step {i}", flush=True)
                os._exit(42)
            state, _ = trainer.train_step(state, next(data_iter))
            if trainer.ckpt_dir and (i + 1) % trainer.ckpt_every == 0:
                trainer.save(i + 1, state)
        return

    state = trainer.run(state, args.steps)
    losses = [m["loss"] for m in trainer.metrics_history]
    out = {
        "arch": args.arch,
        "device": str(dev),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps": len(losses),
        "stragglers": sum(m["straggler"] for m in trainer.metrics_history),
        "final_step": int(state.step),
    }
    print(json.dumps(out))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"summary": out, "history": trainer.metrics_history},
                      f)


if __name__ == "__main__":
    main()
