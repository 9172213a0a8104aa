"""Training launcher (port of ``repro/launch/train.py``, the same flags and
defaults).

Trains an LM arch on the synthetic token pipeline through
``train/loop.py:Trainer``: seeded weights projected onto the DBB constraint,
AdamW with a warm-up of ``max(steps // 20, 5)`` and a cosine decay over
``--steps``, the DBB projection after every update (annealed from dense over
``--prune-anneal-steps`` when given), auto-resume from ``--ckpt-dir``. It runs
on the card unless ``--device cpu`` is given; ``--smoke`` takes the arch's
reduced config:

  python -m repro_torch.launch.train --arch codeqwen1.5-7b --smoke --device cpu --steps 50
  python -m repro_torch.launch.train --arch starcoder2-7b --smoke --steps 50 --ckpt-dir ckpt

A full-size config trains only if its parameters and optimizer state (16
bytes a parameter) fit one card. ``--distributed`` and ``--multi-pod``
(the reference's production mesh) raise ``NotImplementedError``: the port's
distribution is ROADMAP queue 1, item 14.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.sparse_linear import PruneSchedule
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import LM
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import LoopConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--sparsity", type=float, default=0.625)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--prune-anneal-steps", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="build the production mesh and shard (not ported)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.distributed or args.multi_pod:
        raise NotImplementedError(
            "--distributed / --multi-pod: the port trains on one device; its mesh and "
            "sharding are ROADMAP queue 1, item 14")

    sparsity = None if args.dense else args.sparsity
    cfg = (smoke_config if args.smoke else get_config)(args.arch, sparsity=sparsity)
    opt = OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                    decay_steps=args.steps, grad_compression=args.grad_compression)
    data = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch)
    loop = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    sched = PruneSchedule(0, args.prune_anneal_steps) if args.prune_anneal_steps else None
    trainer = Trainer(LM(cfg), opt, data, loop, sched, device=args.device)
    _, _, history = trainer.run()
    if len(history) >= 2:
        print(f"loss: {history[0][1]:.3f} -> {history[-1][1]:.3f}")
    return history


if __name__ == "__main__":
    main()
