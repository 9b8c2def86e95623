"""Deterministic synthetic token pipeline, host-shardable (counterpart
of ``repro.data.pipeline``, whose numpy batches it reproduces bit for
bit).

Two modes:

* ``random`` — i.i.d. tokens (throughput benchmarking; loss stays at
  ln(V)).
* ``lcg``    — sequences from a learnable affine-recurrence language
  (tok_{t+1} = (a * tok_t + b) mod V with per-sequence (a, b) drawn from
  a tiny set): a model must learn the hidden automaton, so loss
  *decreases* — used by convergence tests.

Batch ``step`` on host ``h`` is a pure function of (seed, step, h), so a
restart from a checkpoint sees the batches it would have seen. Batches
are numpy on the host; the train loop moves them to the device. On a
mesh every rank makes the same global batch and
:func:`make_global_batch` keeps this rank's rows (its block over the
data axes) on its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Sequence

import numpy as np
import torch


@dataclass
class SyntheticLMData:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    mode: str = "lcg"            # lcg | random
    n_hosts: int = 1
    host_id: int = 0
    frontend: str = "token"      # token | patch | frame (stub embeddings)
    d_model: int = 0             # needed for non-token frontends

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        self._a_set = np.array([3, 5, 7, 11, 13], np.int64)
        self._b_set = np.array([1, 2, 4, 8, 16], np.int64)

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Host-local slice of the global batch for `step`."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S, V = self.host_batch, self.seq_len, self.vocab_size
        if self.mode == "random":
            toks = rng.integers(0, V, size=(B, S + 1), dtype=np.int64)
        else:
            a = self._a_set[rng.integers(0, len(self._a_set), size=(B, 1))]
            b = self._b_set[rng.integers(0, len(self._b_set), size=(B, 1))]
            x0 = rng.integers(0, V, size=(B, 1), dtype=np.int64)
            toks = np.empty((B, S + 1), np.int64)
            toks[:, 0:1] = x0
            for t in range(S):
                toks[:, t + 1:t + 2] = (a * toks[:, t:t + 1] + b) % V
        out: Dict[str, np.ndarray] = {
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.frontend == "token":
            out["tokens"] = toks[:, :-1].astype(np.int32)
        else:
            # stubbed modality frontend: deterministic embeddings derived
            # from the token ids (so the mapping stays learnable)
            emb_rng = np.random.default_rng(self.seed + 17)
            table = emb_rng.standard_normal(
                (self.vocab_size, self.d_model)).astype(np.float32)
            out["embeds"] = table[toks[:, :-1]]
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield {k: torch.from_numpy(v)
                   for k, v in self.batch_at(step).items()}
            step += 1


def host_shard(batch: Dict[str, np.ndarray], host_id: int,
               n_hosts: int) -> Dict[str, np.ndarray]:
    def slc(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: slc(v) for k, v in batch.items()}


def batch_dim(name: str, ndim: int) -> int:
    """The batch dim of a batch leaf: 1 for M-RoPE positions (3, B, S),
    else 0."""
    return 1 if name == "positions" and ndim == 3 else 0


def make_global_batch(batch: Dict[str, np.ndarray], mesh,
                      batch_axes: Sequence[str] = ("pod", "data"),
                      ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (every rank holds the same
    host batch), split over those of ``batch_axes`` the mesh has, in
    their order, on the mesh's device: the counterpart of the
    reference's ``make_global_batch``, whose arrays carry the same rows
    on each device. A positions leaf of M-RoPE (3, B, S) splits its
    dim 1."""
    axes = [a for a in batch_axes if a in mesh.sizes]
    n, idx = 1, 0
    for a in axes:
        idx = idx * mesh.sizes[a] + mesh.coords[a]
        n *= mesh.sizes[a]

    def rows(name, x):
        x = torch.as_tensor(x)
        dim = batch_dim(name, x.dim())
        if x.shape[dim] % n:
            raise ValueError(f"batch leaf {name!r} has {x.shape[dim]} rows:"
                             f" they do not split over {axes} ({n} ranks)")
        per = x.shape[dim] // n
        return x.narrow(dim, idx * per, per).to(mesh.device)

    return {k: rows(k, v) for k, v in batch.items()}
