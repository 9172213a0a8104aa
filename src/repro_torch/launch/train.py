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

A full-size config trains on one card only if its parameters and optimizer
state (16 bytes a parameter) fit it. ``--distributed`` builds the
reference's production mesh, 16 x 16 (data, model), or 2 x 16 x 16 (pod,
data, model) with ``--multi-pod``, over the world that ``torchrun`` starts
(NCCL on the cards, gloo with ``--device cpu``; one card a rank, by
``LOCAL_RANK``), the rules for training at the mesh's tensor-parallel
degree, and shards the parameters and optimizer state by ``LM.pspecs``;
``--global-batch`` must divide over the data axes. A world of another size
raises and names the sizes it needs:

  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
      --arch qwen2-72b --distributed --global-batch 256
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs import CNN_ARCHS, get_config, smoke_config
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
                    help="build the production mesh and shard (under torchrun)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.arch in CNN_ARCHS:
        ap.error(f"--arch {args.arch}: a CNN; this trainer trains the LM registry's archs "
                 "(configs/registry.py), and the port has no CNN trainer")

    sparsity = None if args.dense else args.sparsity
    cfg = (smoke_config if args.smoke else get_config)(args.arch, sparsity=sparsity)
    opt = OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                    decay_steps=args.steps, grad_compression=args.grad_compression)
    data = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch)
    loop = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    sched = PruneSchedule(0, args.prune_anneal_steps) if args.prune_anneal_steps else None
    mesh = rules = None
    if args.multi_pod and not args.distributed:
        raise ValueError("--multi-pod picks the mesh of --distributed; give both")
    if args.distributed:
        mesh, rules = production_mesh(cfg, args.device, multi_pod=args.multi_pod)
    trainer = Trainer(LM(cfg), opt, data, loop, sched, device=args.device, mesh=mesh,
                      rules=rules)
    _, _, history = trainer.run()
    if len(history) >= 2:
        print(f"loss: {history[0][1]:.3f} -> {history[-1][1]:.3f}")
    return history


def production_mesh(cfg, device=None, *, multi_pod: bool = False):
    """``(mesh, rules)``: the production mesh over the default process group
    (started here from ``torchrun``'s environment when it is not up yet)
    and the training rules at its tensor-parallel degree."""
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.launch.mesh import make_production_mesh, tp_degree
    from repro_torch.sharding.rules import make_rules

    dev = resolve_device(device)
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"--distributed runs under torchrun: {', '.join(missing)} "
                               "unset and no process group up")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    return mesh, make_rules(cfg, tp=tp_degree(mesh), multi_pod=multi_pod, mode="train")


if __name__ == "__main__":
    main()
