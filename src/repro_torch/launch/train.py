"""Training launcher of the port:
``python -m repro_torch.launch.train --arch <id> [--smoke] [--device cpu]``

The reference launcher's loop: the deterministic data pipeline, AdamW
(with WSD where the arch names it), gradient accumulation, the
straggler monitor and async checkpoints with a restart from the latest
one. Same flags, defaults and printed lines as
``python -m repro.launch.train``; ``--device`` (default ``cuda``) picks
the card, where the hand-written kernels run forward under autograd, or
the CPU, where their plain versions run. ``--recipe`` is refused until
the multi-GPU slice (ROADMAP.md Queue 1 item 12).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_arch, smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.dist.fault import StepMonitor
from repro_torch.models import ModelRuntime, init_params
from repro_torch.train import AdamWConfig, TrainConfig, train_loop
from repro_torch.train.loop import check_recipe, init_state
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default) needs a card; cpu runs the "
                         "kernels' plain versions")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--recipe", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    check_recipe(args.recipe)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    rt = ModelRuntime(dtype=args.dtype, remat="none", attn_chunk=128,
                      device=args.device)

    data = SyntheticLMData(args.seq, args.batch, cfg.vocab_size,
                           seed=args.seed, mode="lcg",
                           frontend=cfg.frontend, d_model=cfg.d_model)
    tc = TrainConfig(
        opt=AdamWConfig(peak_lr=args.lr, warmup_steps=max(5, args.steps // 20),
                        total_steps=args.steps, schedule=cfg.lr_schedule
                        if cfg.lr_schedule == "wsd" else "cosine"),
        microbatches=args.microbatches,
        max_steps=args.steps, log_every=max(1, args.steps // 20),
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0)

    params = init_params(cfg, seed=args.seed, device=args.device)
    state = init_state(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    devices = torch.cuda.device_count() if args.device == "cuda" else 1
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"devices={devices} schedule={tc.opt.schedule}")

    ckpt_fn = None
    ckpter = None
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            print(f"restoring from step {last}")
            state = restore(args.ckpt_dir, last, state)
        ckpter = AsyncCheckpointer(args.ckpt_dir)
        ckpt_fn = lambda step, st: ckpter.submit(step, st)   # noqa: E731

    monitor = StepMonitor(
        on_straggler=lambda ev: print(
            f"[fault] straggler at step {ev.step}: {ev.duration:.2f}s "
            f"vs median {ev.median:.2f}s"))

    state = train_loop(cfg, rt, tc, state, iter(data),
                       ckpt_fn=ckpt_fn, monitor=monitor)
    if ckpter is not None:
        ckpter.submit(args.steps, {k: v for k, v in state.items()
                                   if not k.startswith("_")})
        ckpter.close()
    losses = state["_losses"]
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({len(losses)} steps, median step "
          f"{monitor.median:.2f}s)")


if __name__ == "__main__":
    main()
