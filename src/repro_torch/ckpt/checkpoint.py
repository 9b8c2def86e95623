"""Checkpoint save/restore with async writes (counterpart of
``repro.ckpt.checkpoint``), in the reference's on-disk layout, so each
package reads what the other writes.

Layout: ``<dir>/step_<N>/{manifest.json, <leaf-id>.npy...}`` — one file
per tree leaf, named from the leaf's path as the reference names it
(``jax.tree_util.keystr`` sanitised: ``['opt']['mu']['blocks']['wq']``
is ``opt_mu_blocks_wq``). A ``_COMPLETE`` marker commits the checkpoint
atomically: an interrupted write is never restored. A bf16 leaf is
stored as the reference stores one: 2-byte records (numpy has no bf16,
so the file's dtype is ``|V2``) under the manifest dtype ``bfloat16``;
every leaf is read back by its manifest dtype (:func:`read_leaf`).
``models.convert.load_checkpoint`` reads the same layout as a tree of
numpy arrays, without a tree to restore into.

On a mesh (``layout``: a ``dist.sharding.TreeLayout``) every rank holds
its blocks: :func:`save` has rank 0 lay out each leaf's whole file and
every rank write the blocks it owns into it in place (no leaf is
gathered), so the files equal a one-device save of the same tree byte
for byte; :func:`restore_elastic` reads them onto any mesh, each rank
reading only its own block of each leaf (the reference's re-sharding
restore after a re-plan, ``dist.fault.pow2_mesh_shape``).
:class:`AsyncCheckpointer` on a mesh saves the same way, blocking: the
write is a collective of every rank.
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


#: The manifest dtype of a bf16 leaf (the reference's ``str(arr.dtype)``)
#: and the 2-byte records its file holds.
BF16, BF16_RECORD = "bfloat16", np.dtype("V2")


def _host(leaf):
    """``leaf`` on the host; a tensor is copied, so that the train step's
    in-place updates cannot reach the copy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _record_dtype(t: torch.Tensor) -> Tuple[np.dtype, str]:
    """The file's record dtype of a tensor leaf and its manifest dtype."""
    if t.dtype == torch.bfloat16:
        return BF16_RECORD, BF16
    dt = torch.empty(0, dtype=t.dtype).numpy().dtype
    return dt, str(dt)


def _records(leaf) -> Tuple[np.ndarray, str]:
    """The array a leaf is written as, and its manifest dtype: a bf16
    tensor as its 2-byte records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_RECORD), BF16
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def read_leaf(path: str, dtype: str, index=None) -> torch.Tensor:
    """The ``.npy`` leaf at ``path`` as a CPU tensor of manifest dtype
    ``dtype``: 2-byte records under ``bfloat16`` are bf16 bits. With
    ``index`` (a tuple of slices) only that block is read."""
    if index is None:
        arr = np.load(path)
    else:
        arr = np.array(np.load(path, mmap_mode="r")[index])
    if dtype == BF16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: a bfloat16 leaf of {arr.dtype} "
                             f"records")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"{path}: dtype {arr.dtype} != manifest {dtype}")
    return torch.from_numpy(arr)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree, extra: Optional[Dict] = None,
         layout=None) -> str:
    """Blocking save: writes each leaf from host memory. With ``layout``
    (a ``TreeLayout``: ``tree`` is this rank's blocks) every rank must
    call it: rank 0 creates each leaf's whole file, every rank writes
    the blocks it owns into it, and rank 0 commits."""
    path = _step_dir(directory, step)
    tmp = path + ".tmp"
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    if layout is not None:
        return _save_from_mesh(path, tmp, manifest, tree, layout)
    _fresh(tmp)
    for keys, leaf in tree_items(tree):
        key = _keystr(keys)
        arr, dtype = _records(leaf)
        np.save(os.path.join(tmp, _fname(key) + ".npy"), arr)
        manifest["leaves"][_fname(key)] = {
            "path": key, "shape": list(arr.shape), "dtype": dtype}
    _commit(path, tmp, manifest)
    return path


def _fresh(tmp: str) -> None:
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)


def _commit(path: str, tmp: str, manifest: Dict) -> None:
    """The manifest and the ``_COMPLETE`` marker, then ``tmp`` renamed
    to ``path`` (an interrupted write is never restored)."""
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _save_from_mesh(path: str, tmp: str, manifest: Dict, tree,
                    layout) -> str:
    """:func:`save` from every rank of a mesh: each leaf's ``.npy`` is
    laid out whole by rank 0 (the header ``np.save`` writes), then each
    block is written in place by the rank that owns it."""
    blocks = list(layout.blocks(tree))
    if layout.writer:
        _fresh(tmp)
        for keys, block, _, shape, _, _ in blocks:
            key = _keystr(keys)
            record, dtype = _record_dtype(block)
            np.lib.format.open_memmap(
                os.path.join(tmp, _fname(key) + ".npy"), mode="w+",
                dtype=record, shape=shape).flush()
            manifest["leaves"][_fname(key)] = {
                "path": key, "shape": list(shape), "dtype": dtype}
    layout.barrier()
    for keys, block, _, _, index, owned in blocks:
        if owned:
            out = np.load(os.path.join(tmp, _fname(_keystr(keys)) + ".npy"),
                          mmap_mode="r+")
            out[index] = _records(block)[0]
            out.flush()
            del out
    layout.barrier()
    if layout.writer:
        _commit(path, tmp, manifest)
    layout.barrier()
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
    ``step``: each leaf in its saved (manifest) dtype, on its ``like``
    leaf's device. Refuses an incomplete checkpoint."""
    path = _step_dir(directory, step)
    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(f"incomplete or missing checkpoint at "
                                f"{path} (no _COMPLETE marker)")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    out = {}
    for keys, leaf in tree_items(like):
        name = _fname(_keystr(keys))
        t = read_leaf(os.path.join(path, name + ".npy"),
                      leaves[name]["dtype"])
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.to(leaf.device)
    return out


def restore_elastic(directory: str, step: int, like, shardings) -> Any:
    """Elastic restore: the same bytes onto a new mesh. ``shardings``
    mirrors ``like`` with this rank's index tuple of each leaf (a
    ``TreeLayout``'s ``slices()`` for the new mesh's placement: the
    counterpart of the reference's tree of ``NamedSharding``s); each
    leaf is read in its saved dtype and this rank's block copied onto
    its ``like`` leaf's device."""
    path = _step_dir(directory, step)
    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(f"incomplete or missing checkpoint at "
                                f"{path} (no _COMPLETE marker)")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    index = dict(tree_items(shardings))
    out = {}
    for keys, leaf in tree_items(like):
        name = _fname(_keystr(keys))
        block = read_leaf(os.path.join(path, name + ".npy"),
                          leaves[name]["dtype"], index[keys])
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(block.shape, dtype=block.dtype,
                                     device=leaf.device).copy_(block)
    return out


class AsyncCheckpointer:
    """Background-thread writer: the train loop hands off host copies
    and keeps stepping while the previous checkpoint hits disk. With
    ``layout`` (a mesh) :meth:`submit` is a collective that returns once
    the checkpoint is written: every rank writes its blocks in place
    (:func:`save`) and rank 0 drops the old steps."""

    def __init__(self, directory: str, keep: int = 3, layout=None):
        self.directory = directory
        self.keep = keep
        self.layout = layout
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
        if self.layout is not None:
            save(self.directory, step, tree, extra, layout=self.layout)
            if self.layout.writer:
                self._gc()
            return
        self._q.put((step, tree_map(_host, tree), extra))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
