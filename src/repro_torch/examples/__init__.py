"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart`` (the paper's flow end to end, its pod step on one card)
and ``explore_accelerator`` (the paper's Fig. 10/11 experiments live and
the one-card DSE across the port's model families)."""
