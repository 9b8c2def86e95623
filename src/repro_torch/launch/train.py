"""Training launcher of the port:
``python -m repro_torch.launch.train --arch <id> [--smoke] [--device cpu]
[--recipe IS|WS|IS_seq|WS_seq] [--mesh DxM]``

The reference launcher's loop: the deterministic data pipeline, AdamW
(with WSD where the arch names it), gradient accumulation, the
straggler monitor and async checkpoints with a restart from the latest
one. Same flags, defaults and printed lines as
``python -m repro.launch.train``; ``--device`` (default ``cuda``) picks
the card, where the hand-written kernels run forward under autograd, or
the CPU, where their plain versions run.

``--mesh DxM`` trains on a (data, model) mesh of D x M ranks, one
process each (``launch.mesh.run_mesh``: on one card the ranks share it
over ``gloo``, on D x M cards each has its own over ``nccl``; on the
CPU with ``--device cpu``), under ``--recipe`` (default the reference
launcher's for training: IS, or IS_seq where the heads do not divide
over M): the port's counterpart of the reference training on every
device JAX sees. The weights are drawn once, here, and each rank copies
its blocks of them; on the card the kernel library is built here and
the ranks load it. Rank 0's lines are printed when the run ends, and
every rank's losses must equal rank 0's. With ``--ckpt-dir`` the mesh
writes whole leaves (the files of a one-device run), and a resume on
another ``--mesh`` or recipe reads each rank's blocks of them
(``ckpt.restore_elastic``). Every family the one-device launcher
trains runs on a mesh (the MoE, SSM and hybrid ones under the recipe's
expert and head-aligned placements, ``dist.sharding``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.ckpt import (AsyncCheckpointer, latest_step, restore,
                              restore_elastic)
from repro_torch.configs import get_arch, smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.dist.fault import StepMonitor
from repro_torch.dist.sharding import default_recipe, use_mesh
from repro_torch.launch.mesh import parse_mesh, run_mesh
from repro_torch.models import ModelRuntime, init_params
from repro_torch.train import AdamWConfig, TrainConfig, train_loop
from repro_torch.train.loop import (check_recipe, init_state, shard_state,
                                    state_layout)
from repro_torch.tree import tree_leaves


def _monitor(log):
    return StepMonitor(on_straggler=lambda ev: log(
        f"[fault] straggler at step {ev.step}: {ev.duration:.2f}s "
        f"vs median {ev.median:.2f}s"))


def _train(cfg, rt, tc, state, data, recipe, ckpt_dir, steps, log,
           restore_fn, layout=None):
    """The loop of one process (one device, or one rank of a mesh):
    restore, train, checkpoint. Returns (losses, the monitor's median
    step s, the step restored from)."""
    ckpt_fn = ckpter = None
    last = None
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            log(f"restoring from step {last}")
            state = restore_fn(ckpt_dir, last, state)
        ckpter = AsyncCheckpointer(ckpt_dir, layout=layout)
        ckpt_fn = lambda step, st: ckpter.submit(step, st)   # noqa: E731
    monitor = _monitor(log)
    state = train_loop(cfg, rt, tc, state, iter(data), recipe,
                       ckpt_fn=ckpt_fn, monitor=monitor, log=log)
    if ckpter is not None:
        ckpter.submit(steps, {k: v for k, v in state.items()
                              if not k.startswith("_")})
        ckpter.close()
    return state["_losses"], monitor.median, last


def _mesh_rank(mesh, params, cfg, rt, tc, data, recipe, ckpt_dir,
               steps) -> dict:
    """One rank of ``--mesh``: its blocks of ``params``, the loop under
    the mesh and ``recipe``; rank 0 keeps the printed lines."""
    lines = []
    log = lines.append if mesh.rank == 0 else (lambda _: None)
    with use_mesh(mesh):
        state = shard_state(params, cfg, recipe)
        layout = state_layout(cfg, mesh.placement(cfg, recipe))

        def restore_fn(d, step, like):
            return restore_elastic(d, step, like, layout.slices())

        losses, median, last = _train(cfg, rt, tc, state, data, recipe,
                                      ckpt_dir, steps, log, restore_fn,
                                      layout)
    return dict(rank=mesh.rank, backend=mesh.backend, lines=lines,
                losses=losses, median=median, restored=last)


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
    ap.add_argument("--recipe", default=None,
                    help="a sharding recipe of RECIPES (IS, WS, IS_seq, "
                         "WS_seq)")
    ap.add_argument("--mesh", default=None,
                    help="DxM device mesh, e.g. 2x2 -> (data, model): one "
                         "process a rank")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    recipe = check_recipe(args.recipe)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    mesh_shape = None
    if args.mesh:
        mesh_shape, sizes = parse_mesh(args.mesh)
        if recipe is None:
            recipe = default_recipe(cfg, "train", sizes["model"])
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
    n_params = sum(x.numel() for x in tree_leaves(params))
    if mesh_shape is not None:
        devices = mesh_shape[0] * mesh_shape[1]
    else:
        devices = torch.cuda.device_count() if args.device == "cuda" else 1
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"devices={devices} schedule={tc.opt.schedule}")

    if mesh_shape is not None:
        if args.device == "cuda":
            from repro_torch.kernels import _build
            _build.library()           # built once, here; the ranks load it
        runs = run_mesh(_mesh_rank, mesh_shape, params, cfg, rt, tc, data,
                        recipe, args.ckpt_dir, args.steps,
                        devices=args.device)
        del params
        for r in runs[1:]:
            if r["losses"] != runs[0]["losses"]:
                raise RuntimeError(f"rank {r['rank']} trained to other "
                                   f"losses than rank 0")
        run = runs[0]
        for line in run["lines"]:
            print(line)
        losses, median, last = run["losses"], run["median"], run["restored"]
        print(f"mesh {mesh_shape[0]}x{mesh_shape[1]} (data, model), recipe "
              f"{recipe.name}, over {run['backend']}: every rank's losses "
              f"equal rank 0's")
    else:
        state = init_state(params)
        losses, median, last = _train(
            cfg, rt, tc, state, data, recipe, args.ckpt_dir, args.steps,
            print, restore)
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({len(losses)} steps, median step "
          f"{median:.2f}s)")
    return dict(losses=losses, restored=last, median_s=median,
                recipe=recipe.name if recipe is not None else None,
                mesh=mesh_shape)


if __name__ == "__main__":
    main()
