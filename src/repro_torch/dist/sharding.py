"""Logical-axis sharding of the port (counterpart of
``repro.dist.sharding``).

Recipes map *logical* tensor axes (``embed``, ``heads``, ``ffn``, ...)
to mesh axes (``data``, ``model``, ``pod``): IS (weights streamed over
``data`` too) against WS (weights resident, tensor-parallel over
``model``), their sequence-parallel variants and the serving recipe
``decode``. The five recipes, :func:`sanitize_spec` and its
:class:`SpecDrop` records are the reference's, with specs as plain
tuples: an indivisible or missing mesh axis degrades to replication and
is recorded, never raised.

Where the reference leaves placement to GSPMD, the port places each
leaf itself (:class:`Placement`, :func:`shard_tree`): a rank holds the
block of every dim its coordinates select, with one exception, the
attention heads. A query head never straddles two ranks, and each rank
stores and projects exactly the K/V heads its query heads read, as a
tensor-parallel server does: with 2 K/V heads over 4 ranks each rank
holds the one its two query heads share, where the recipe's spec would
keep both (indivisible) or cut a head in half (``wk``'s ``2 * hd``
columns). When the query heads do not divide over ``model`` the
attention stays whole on every rank. The specs and the drops stay the
reference's; only the bytes of those leaves depart from them
(``tests/test_torch_sharding.py`` pins which).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

AxisEntry = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[AxisEntry, ...]


# ---------------------------------------------------------------------------
# Recipes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Recipe:
    """A named mapping logical-axis -> mesh axes (None = replicate)."""

    name: str
    rules: Dict[str, AxisEntry] = field(default_factory=dict)

    def spec_for(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        return tuple(self.rules.get(a) if a is not None else None
                     for a in logical_axes)

    def with_rules(self, **updates: AxisEntry) -> "Recipe":
        rules = dict(self.rules)
        rules.update(updates)
        return Recipe(self.name, rules)

    def replace_name(self, name: str) -> "Recipe":
        return Recipe(name, dict(self.rules))

    def key(self) -> Tuple:
        return (self.name, tuple(sorted(self.rules.items())))


_COMMON: Dict[str, AxisEntry] = {
    # activation-only axes
    "batch": ("pod", "data"),
    "tokens": ("pod", "data"),
    "seq": None,
    "q_seq": None,
    # KV-cache rows stay whole on every rank: declared (rather than
    # absent) so the contract checker tells replicate-by-design from
    # nobody-decided (contract-axis-unresolvable)
    "kv_seq": None,
    "head_dim": None,
    "capacity": None,
    "layers": None,
}

# IS: weights sharded over `data` too (streamed / ZeRO-3), compute TP'd
IS_RECIPE = Recipe("IS", {
    **_COMMON,
    "embed": ("data",),
    "heads": ("model",),
    "heads_full": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "expert_ffn": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
})

# WS: weights resident, sharded over `model` only (Megatron-style TP)
WS_RECIPE = Recipe("WS", {
    **_COMMON,
    "embed": None,
    "heads": ("model",),
    "heads_full": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "expert_ffn": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
})

# *_SEQ: head counts indivisible by the model axis — attention shards
# query rows (sequence parallel) instead of heads.
IS_SEQ_RECIPE = IS_RECIPE.with_rules(
    heads=None, heads_full=None, kv_heads=None,
    q_seq=("model",)).replace_name("IS_seq")
WS_SEQ_RECIPE = WS_RECIPE.with_rules(
    heads=None, heads_full=None, kv_heads=None,
    q_seq=("model",)).replace_name("WS_seq")

# decode: one token per sequence; KV cache sharded over heads, weights
# resident (WS) — batch is the only streaming dimension.
DECODE_RECIPE = WS_RECIPE.replace_name("decode")

RECIPES: Dict[str, Recipe] = {
    "IS": IS_RECIPE,
    "WS": WS_RECIPE,
    "IS_seq": IS_SEQ_RECIPE,
    "WS_seq": WS_SEQ_RECIPE,
    "decode": DECODE_RECIPE,
}


def default_recipe(cfg, kind: str, model_axis: int = 16) -> Recipe:
    """The reference launcher's recipe for a step kind (``repro.launch.
    lowering.default_recipe``): IS for training, WS for prefill, decode
    otherwise; the ``*_seq`` variants when the heads do not divide, and
    weights over ``data`` too when bf16 weights over ``model`` pass 12
    GB."""
    heads_divide = cfg.n_heads % model_axis == 0 and cfg.family != "ssm"
    big = cfg.param_count() * 2 / model_axis > 12e9
    if kind == "train":
        return IS_RECIPE if heads_divide else IS_SEQ_RECIPE
    if kind == "prefill":
        base = WS_RECIPE if heads_divide else WS_SEQ_RECIPE
        return base.with_rules(embed=("data",)).replace_name(
            base.name + "+zero3") if big else base
    return DECODE_RECIPE.with_rules(embed=("data",)).replace_name(
        DECODE_RECIPE.name + "+zero3") if big else DECODE_RECIPE


# ---------------------------------------------------------------------------
# Spec sanitization
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SpecDrop:
    """One mesh axis :func:`sanitize_spec` removed from a requested
    spec. ``reason`` is ``missing-axis`` (the mesh lacks it; routine for
    ``pod`` on 2-axis meshes), ``axis-reused`` (already sharding another
    dim) or ``indivisible`` (its extent does not divide the dim — the
    one that replicates real bytes)."""

    path: Optional[str]             # leaf path when the caller knows it
    axis: str                       # the dropped mesh axis
    spec: Tuple                     # the entries requested for the dim
    dim: int                        # dim size the axis failed against
    shape: Tuple[int, ...]
    mesh_sizes: Tuple[Tuple[str, int], ...]
    reason: str                     # missing-axis | axis-reused | indivisible


#: Bounded record of every drop since the last reset (the total keeps
#: counting past the cap).
_SPEC_DROPS: list = []
_SPEC_DROP_CAP = 4096
_SPEC_DROP_TOTAL = 0


def reset_spec_drops() -> None:
    global _SPEC_DROP_TOTAL
    _SPEC_DROPS.clear()
    _SPEC_DROP_TOTAL = 0


def spec_drops() -> Tuple[SpecDrop, ...]:
    return tuple(_SPEC_DROPS)


def spec_drop_count(reason: Optional[str] = None) -> int:
    """Drops recorded since the last reset (cap-proof total when
    ``reason`` is None)."""
    if reason is None:
        return _SPEC_DROP_TOTAL
    return sum(1 for d in _SPEC_DROPS if d.reason == reason)


def _record_drop(drop: SpecDrop) -> None:
    global _SPEC_DROP_TOTAL
    _SPEC_DROP_TOTAL += 1
    if len(_SPEC_DROPS) < _SPEC_DROP_CAP:
        _SPEC_DROPS.append(drop)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis-name -> size of a dict, of the port's ``launch.mesh.Mesh`` or
    of anything with ``axis_names`` and ``axis_sizes``; ``None`` -> one
    device."""
    if mesh is None:
        return {"data": 1, "model": 1}
    if isinstance(mesh, dict):
        return {k: int(v) for k, v in mesh.items()}
    names = getattr(mesh, "axis_names", None)
    sizes = getattr(mesh, "axis_sizes", None)
    if names is not None and sizes is not None:
        return dict(zip(names, (int(s) for s in sizes)))
    raise TypeError(f"cannot read mesh axis sizes from {type(mesh)!r}")


def _parts(entry: AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sanitize_spec(spec: Spec, shape: Tuple[int, ...], mesh,
                  path: Optional[str] = None) -> Spec:
    """Make ``spec`` legal for a tensor of ``shape`` on ``mesh``: drop
    mesh axes the mesh does not have, never use one mesh axis on two
    dims, keep a sharding only where its extent divides the dim. Every
    drop is recorded (:func:`spec_drops`, with ``path`` when the caller
    names the leaf). Trailing ``None`` entries are trimmed."""
    return _sanitize(spec, shape, mesh_sizes(mesh), path, record=True)


def _sanitize(spec: Spec, shape: Tuple[int, ...], sizes: Dict[str, int],
              path: Optional[str], record: bool) -> Spec:
    msizes = tuple(sizes.items())
    used: set = set()
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, entry in zip(shape, entries):
        parts = _parts(entry)
        kept = []
        ext = 1
        for ax in parts:
            reason = None
            if ax not in sizes:
                reason = "missing-axis"
            elif ax in used:
                reason = "axis-reused"
            elif dim % (ext * sizes[ax]) != 0:
                reason = "indivisible"
            if reason is not None:
                if record:
                    _record_drop(SpecDrop(path, ax, parts, dim,
                                          tuple(shape), msizes, reason))
                continue
            kept.append(ax)
            used.add(ax)
            ext *= sizes[ax]
        out.append(None if not kept
                   else kept[0] if len(kept) == 1 else tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# ---------------------------------------------------------------------------
# The ambient mesh + recipe
# ---------------------------------------------------------------------------
class _Active(threading.local):
    def __init__(self):
        self.recipe: Optional[Recipe] = None
        self.mesh = None


_ACTIVE = _Active()


@contextmanager
def axis_rules(recipe: Optional[Recipe]):
    """Install ``recipe`` as the ambient logical -> mesh mapping;
    ``axis_rules(None)`` is a no-op context (one device)."""
    prev = _ACTIVE.recipe
    _ACTIVE.recipe = recipe
    try:
        yield recipe
    finally:
        _ACTIVE.recipe = prev


@contextmanager
def use_mesh(mesh):
    """Install ``mesh`` (a ``launch.mesh.Mesh``) as the ambient mesh the
    model's tensor-parallel forms read."""
    prev = _ACTIVE.mesh
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


#: The families whose blocks the tensor-parallel forms cover (attention
#: + MLP); the rest wait for the next slice of the port.
MESH_FAMILIES = ("dense", "vlm")


def check_mesh_family(cfg, sizes: Dict[str, int]) -> None:
    """Raise for a family the mesh forms do not cover on a mesh of more
    than one device."""
    if math.prod(sizes.values()) > 1 and cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on mesh {sizes}: the sharded "
            f"engines cover {MESH_FAMILIES}; MoE, SSM and hybrid models on "
            f"a mesh come with training's distributed half (ROADMAP.md "
            f"Queue 1 item 12, the next slice)")


def active_placement(cfg) -> Optional["Placement"]:
    """The placement of ``cfg`` on the ambient mesh under the ambient
    recipe, or None on one device (no mesh, no recipe, or a mesh of one
    device): then the model runs exactly its one-device form."""
    mesh, recipe = _ACTIVE.mesh, _ACTIVE.recipe
    if mesh is None or recipe is None or mesh.devices == 1:
        return None
    return mesh.placement(cfg, recipe)


# ---------------------------------------------------------------------------
# The port's placement
# ---------------------------------------------------------------------------
class Placement:
    """Where every leaf of one model lives on one rank of a mesh.

    ``mesh`` is a ``launch.mesh.Mesh`` (the live form, whose collectives
    the model calls) or a dict of axis sizes (the host-only form the
    capacity model reads: rank 0's coordinates, no collectives). Every
    rank's blocks have the same shape.
    """

    def __init__(self, cfg, recipe: Recipe, mesh, coords=None):
        self.cfg, self.recipe, self.mesh = cfg, recipe, mesh
        self.sizes = mesh_sizes(mesh)
        if coords is None:
            coords = getattr(mesh, "coords", None) or {}
        self.coords = {a: int(coords.get(a, 0)) for a in self.sizes}
        self.model = self.sizes.get("model", 1)
        self.heads_split = self._heads_split()
        nq, nkv, M = cfg.n_heads, cfg.n_kv_heads, self.model
        self.q_heads = nq // M if self.heads_split else nq
        r = self.coords.get("model", 0)
        if self.heads_split:
            group = nq // nkv
            lo = r * self.q_heads
            self.kv_start = lo // group
            self.kv_heads = (lo + self.q_heads - 1) // group + 1 \
                - self.kv_start
        else:
            self.kv_start, self.kv_heads = 0, nkv
        self.q_start = r * self.q_heads if self.heads_split else 0
        # the splits the model's collectives follow, from the recipe's
        # specs of the leaves that carry them
        self.vocab_split = self._over_model(("vocab", "embed"),
                                            (cfg.vocab_size, cfg.d_model))
        self.vocab_size = cfg.vocab_size // (M if self.vocab_split else 1)
        self.vocab_start = r * self.vocab_size if self.vocab_split else 0
        self.ffn_split = bool(cfg.d_ff) and self._over_model(
            ("ffn", "embed"), (cfg.d_ff, cfg.d_model))

    def _over_model(self, axes, shape) -> bool:
        """Whether the recipe splits the leading dim over ``model``."""
        spec = _sanitize(self.recipe.spec_for(axes), shape, self.sizes,
                         None, record=False)
        return bool(spec) and "model" in _parts(spec[0])

    def _heads_split(self) -> bool:
        nq, nkv, M = self.cfg.n_heads, self.cfg.n_kv_heads, self.model
        if M <= 1 or _parts(self.recipe.rules.get("heads")) != ("model",):
            return False
        return (nq % M == 0 and nkv >= 1
                and (nkv % M == 0 or M % nkv == 0))

    # ------------------------------------------------------------- blocks
    def slices(self, axes: Sequence[Optional[str]], shape: Tuple[int, ...],
               path: Optional[str] = None,
               whole: Tuple[str, ...] = ()) -> Tuple[slice, ...]:
        """This rank's block of a leaf with logical ``axes``: the
        recipe's sanitized spec, but the attention heads by the head
        plan; dims whose logical axis is in ``whole`` stay whole."""
        axes = tuple(axes or (None,) * len(shape))
        spec = sanitize_spec(self.recipe.spec_for(axes), shape, self.sizes,
                             path=path)
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        out = []
        for dim, name, entry in zip(shape, axes, spec):
            if name in whole:
                out.append(slice(0, dim))
            elif name in ("heads", "kv_heads"):
                out.append(self._head_block(name, dim))
            else:
                parts = _parts(entry)
                ext, idx = 1, 0
                for ax in parts:
                    idx = idx * self.sizes[ax] + self.coords[ax]
                    ext *= self.sizes[ax]
                size = dim // ext
                out.append(slice(idx * size, (idx + 1) * size))
        return tuple(out)

    def _head_block(self, name: str, dim: int) -> slice:
        count = self.cfg.n_heads if name == "heads" else self.cfg.n_kv_heads
        if dim % count:
            raise ValueError(f"a {name} dim of {dim} does not hold "
                             f"{count} whole heads")
        unit = dim // count
        if name == "heads":
            start, n = self.q_start, self.q_heads
        else:
            start, n = self.kv_start, self.kv_heads
        return slice(start * unit, (start + n) * unit)

    def local_shape(self, axes, shape, path=None,
                    whole: Tuple[str, ...] = ()) -> Tuple[int, ...]:
        return tuple(s.stop - s.start
                     for s in self.slices(axes, tuple(shape), path, whole))

    def local_spec(self, spec: Dict[str, Tuple], axes: Dict[str, Tuple],
                   whole: Tuple[str, ...] = ()) -> Dict[str, Tuple]:
        """A ``{name: (shape, dtype)}`` spec at this rank's block shapes."""
        return {k: (self.local_shape(axes[k], s, k, whole), d)
                for k, (s, d) in spec.items()}

    # -------------------------------------------------------- collectives
    def reduce_model(self, t):
        """The sum of ``t`` over ``model`` (a row-parallel product)."""
        return self.mesh.all_reduce(t, "model")

    def gather_model(self, t, dim: int):
        return self.mesh.all_gather(t, "model", dim)

    def gather_batch(self, t, dim: int = 0):
        """``t``'s rows of every rank that holds other slots (the batch
        axis's ``data`` split)."""
        return self.mesh.all_gather(t, "data", dim) if self.batch_split \
            else t

    @property
    def batch_split(self) -> bool:
        return self.sizes.get("data", 1) > 1

    def slot_block(self, n_slots: int) -> slice:
        """The engine's slots this rank holds (its block of ``pos``)."""
        return self.slices(("batch",), (n_slots,), "pos")[0]


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------
def _map(fn, tree, axes, path: str = ""):
    """``fn(path, leaf, axes)`` over a tree, its structure kept; every
    leaf is visited in sorted key order."""
    out = {}
    if not isinstance(tree, dict):
        return fn(path, tree, axes)
    for k in sorted(tree):
        out[k] = _map(fn, tree[k], axes[k], f"{path}['{k}']")
    return {k: out[k] for k in tree}


def param_sharding_tree(axes_tree, recipe: Recipe, mesh, tree) -> Any:
    """The sanitized spec of every leaf of ``tree`` (anything with a
    ``.shape``: tensors, ``ParamDef``s) under ``recipe`` on ``mesh``;
    ``axes_tree`` mirrors it (``models.model.axes_tree`` or the cache
    axes). Drops are recorded with the leaf's path."""
    def spec(path, leaf, axes):
        shape = tuple(leaf.shape)
        axes = axes or (None,) * len(shape)
        return sanitize_spec(recipe.spec_for(axes), shape, mesh, path=path)

    return _map(spec, tree, axes_tree)


def shard_tree(tree, axes_tree, recipe: Recipe, mesh, cfg,
               dtype=None) -> Any:
    """This rank's block of every leaf of ``tree``, copied onto the
    mesh's device one leaf at a time (a rank never holds a whole model
    there), cast to ``dtype(path)`` where that is given.

    ``tree`` may live on the CPU or on a device another process shares
    (CUDA IPC); only the block is read. The blocks follow
    :class:`Placement`."""
    import torch

    pl = Placement(cfg, recipe, mesh) if isinstance(mesh, dict) \
        else mesh.placement(cfg, recipe)
    device = getattr(mesh, "device", torch.device("cpu"))

    def place(path, leaf, axes):
        block = leaf[pl.slices(axes, tuple(leaf.shape), path)]
        dt = dtype(path) if dtype is not None else leaf.dtype
        return torch.empty(block.shape, dtype=dt,
                           device=device).copy_(block)

    return _map(place, tree, axes_tree)
