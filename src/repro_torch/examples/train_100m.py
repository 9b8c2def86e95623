"""End-to-end driver: train a ~100M-parameter minicpm-family model on
the deterministic LCG language with the full production loop (WSD
schedule, async checkpoints, straggler monitor, restart-from-latest).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300

The port's counterpart of ``examples/train_100m.py``: the same config
(8 layers, d 640, vocab 32768), schedule and loop, through the port's
``train``, ``ckpt``, ``data`` and ``dist.fault``, in f32 as the
reference runs it. ``--device`` defaults to ``cuda``, where the
hand-written kernels run forward under autograd; on one CPU core a step
takes O(seconds), so pass ``--device cpu --steps 10`` for a quick
check. Restarting the same command with the same ``--ckpt-dir`` resumes
from the last checkpoint.

``main(argv)`` returns the losses, the step it resumed from (None on a
fresh start) and the checkpoint directory.
"""
from __future__ import annotations

import argparse
import tempfile


def model_config():
    """~100M params: minicpm-2b family, narrowed (8 layers, d 640, vocab
    32768)."""
    from repro_torch.configs import ARCHS
    return ARCHS["minicpm-2b"].replace(
        n_layers=8, d_model=640, n_heads=10, n_kv_heads=10, d_head=64,
        d_ff=1706, vocab_size=32768)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.train_100m")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default) needs a card; cpu runs the "
                         "kernels' plain versions")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist.fault import StepMonitor
    from repro_torch.models import ModelRuntime, init_params
    from repro_torch.train import AdamWConfig, TrainConfig, train_loop
    from repro_torch.train.loop import init_state
    from repro_torch.tree import tree_leaves

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device available: pass --device cpu")
    cfg = model_config()
    rt = ModelRuntime(dtype="float32", remat="none", attn_chunk=128,
                      device=args.device)
    params = init_params(cfg, seed=0, device=args.device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {n/1e6:.1f}M params ({cfg.n_layers}L d={cfg.d_model}), "
          f"WSD schedule")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train100m_")
    data = SyntheticLMData(args.seq, args.batch, cfg.vocab_size,
                           seed=0, mode="lcg")
    tc = TrainConfig(
        opt=AdamWConfig(peak_lr=3e-3, warmup_steps=args.steps // 10,
                        total_steps=args.steps, schedule="wsd"),
        max_steps=args.steps, log_every=max(1, args.steps // 30),
        ckpt_every=max(10, args.steps // 6))

    state = init_state(params)
    start = latest_step(ckpt_dir)
    if start is not None:
        print(f"resuming from checkpoint step {start} in {ckpt_dir}")
        state = restore(ckpt_dir, start, state)
    ckpter = AsyncCheckpointer(ckpt_dir)
    monitor = StepMonitor(on_straggler=lambda ev: print(
        f"[fault] straggler step {ev.step}: {ev.duration:.2f}s"))

    state = train_loop(cfg, rt, tc, state, iter(data),
                       ckpt_fn=lambda s, st: ckpter.submit(s, st),
                       monitor=monitor)
    ckpter.close()
    losses = state["_losses"]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoints in {ckpt_dir}")
    return dict(losses=losses, start=start, ckpt_dir=ckpt_dir,
                n_params=n)


if __name__ == "__main__":
    main()
