"""Checkpoint save/restore with async writes (counterpart of
``repro.ckpt.checkpoint``), in the reference's on-disk layout, so each
package reads what the other writes.

Layout: ``<dir>/step_<N>/{manifest.json, <leaf-id>.npy...}`` — one file
per tree leaf, named from the leaf's path as the reference names it
(``jax.tree_util.keystr`` sanitised: ``['opt']['mu']['blocks']['wq']``
is ``opt_mu_blocks_wq``). A ``_COMPLETE`` marker commits the checkpoint
atomically: an interrupted write is never restored.
``models.convert.load_checkpoint`` reads the same layout as a tree of
numpy arrays, without a tree to restore into. The reference's elastic
restore onto a new mesh waits for the multi-GPU slice (ROADMAP.md Queue
1 item 12).
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_items, tree_map


def _keystr(path: Tuple[str, ...]) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", key).strip("_")


def _host(leaf) -> np.ndarray:
    """``leaf`` as numpy; a tensor is copied, so that the train step's
    in-place updates cannot reach the copy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree, extra: Optional[Dict] = None,
         ) -> str:
    """Blocking save. Copies each leaf to host memory and writes it."""
    path = _step_dir(directory, step)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for keys, leaf in tree_items(tree):
        key = _keystr(keys)
        arr = _host(leaf)
        np.save(os.path.join(tmp, _fname(key) + ".npy"), arr)
        manifest["leaves"][_fname(key)] = {
            "path": key, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "_COMPLETE")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(directory: str, step: int, like) -> Any:
    """The tree of ``like`` (nested dicts of tensors) read back from
    ``step``: each leaf in its saved dtype, on its ``like`` leaf's
    device. Refuses an incomplete checkpoint."""
    path = _step_dir(directory, step)
    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(f"incomplete or missing checkpoint at "
                                f"{path} (no _COMPLETE marker)")
    out = {}
    for keys, leaf in tree_items(like):
        arr = np.load(os.path.join(path, _fname(_keystr(keys)) + ".npy"))
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.from_numpy(arr).to(leaf.device)
    return out


class AsyncCheckpointer:
    """Background-thread writer: the train loop hands off host copies
    and keeps stepping while the previous checkpoint hits disk."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save(self.directory, step, host_tree, extra)
                self._gc()
            except Exception as e:          # surfaced on next submit/close
                self._err = e

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n)
             for n in os.listdir(self.directory)) if m)
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def submit(self, step: int, tree, extra: Optional[Dict] = None):
        if self._err:
            raise self._err
        self._q.put((step, tree_map(_host, tree), extra))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
