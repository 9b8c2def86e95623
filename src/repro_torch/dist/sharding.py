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
attention stays whole on every rank.

Two more leaves depart the same way. The Mamba-2 mixer is head-aligned:
``in_proj``'s columns are ``[z | x | B | C | dt]`` and ``conv``'s
channels ``[x | B | C]``, so a rank takes its own SSD heads' z, x and dt
columns and x channels, its heads' ``A_log``, ``D``, ``dt_bias``,
``norm`` and ``out_proj`` rows and state, and B/C (one group, every
config's) whole on every rank, where the spec's
contiguous block would mix z, x, B, C and dt; when the SSD heads do not
divide over ``model`` the mixer stays whole. The MoE router stays whole
on every rank (the spec splits it over ``experts``): each rank routes
every token from the whole softmax, as one device does, and the expert
weights split as the sanitized spec says, experts over ``model`` when
they divide (expert-parallel), else ``expert_ffn`` (expert-split). The
specs and the drops stay the reference's; only the bytes of those
leaves depart from them (``tests/test_torch_sharding.py`` pins which).

For training the placement also says where each gradient must be
summed: over ``model`` where a replicated tensor enters a split region
(:meth:`Placement.enter_model`), over the ranks that hold one K/V head
(:meth:`Placement.enter_kv`, a subgroup of ``model``), over ``data``
where a leaf is split over ``data`` (IS: :meth:`Placement.gather_data`
gathers it for its layer, and its backward sums) and how many ranks
hold a copy of each block (:meth:`Placement.copies`, the global norm's
weight). :meth:`Placement.local_to_global` assembles a whole leaf from
every rank's block, and :class:`TreeLayout` does so for a tree (a
train state, a checkpoint).
"""
from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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


def zero3(base: Recipe) -> Recipe:
    """``base`` with its weights split over ``data`` too (``embed``):
    ZeRO-3-style inference, each layer gathered just before it runs."""
    return base.with_rules(embed=("data",)).replace_name(
        base.name + "+zero3")


def get_recipe(name: str) -> Recipe:
    """The recipe called ``name``: one of :data:`RECIPES`, or one of
    them with ``+zero3`` (:func:`zero3`); any other name is refused."""
    base, plus, rest = name.partition("+")
    if base not in RECIPES or (plus and rest != "zero3"):
        raise ValueError(f"unknown recipe {name!r}: one of "
                         f"{sorted(RECIPES)}, or one of them + '+zero3'")
    return zero3(RECIPES[base]) if plus else RECIPES[base]


def default_recipe(cfg, kind: str, model_axis: int = 16) -> Recipe:
    """The reference launcher's recipe for a step kind (``repro.launch.
    lowering.default_recipe``): IS for training, WS for prefill, decode
    otherwise; the ``*_seq`` variants when the heads do not divide, and
    weights over ``data`` too (:func:`zero3`) when bf16 weights over
    ``model`` pass 12 GB."""
    heads_divide = cfg.n_heads % model_axis == 0 and cfg.family != "ssm"
    big = cfg.param_count() * 2 / model_axis > 12e9
    if kind == "train":
        return IS_RECIPE if heads_divide else IS_SEQ_RECIPE
    if kind == "prefill":
        base = WS_RECIPE if heads_divide else WS_SEQ_RECIPE
    else:
        base = DECODE_RECIPE
    return zero3(base) if big else base


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


def active_mesh():
    """The ambient mesh (``use_mesh``), or None."""
    return _ACTIVE.mesh


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
        self._moe_plan(r)
        self._ssm_plan(r)
        self._peers = None

    def _moe_plan(self, r: int) -> None:
        """``moe_split``: ``experts`` (each rank runs ``n_experts`` local
        experts from ``expert_start``), ``ffn`` (every expert at its
        ``d_expert`` columns) or None (whole), as the sanitized spec of
        the expert weights splits them; ``shared_split`` for the shared
        experts, which split as the dense MLP does."""
        m, M = self.cfg.moe, self.model
        self.moe_split, self.shared_split = None, False
        self.n_experts = m.n_experts if m is not None else 0
        self.expert_start = 0
        if m is None or M <= 1:
            return
        spec = _sanitize(self.recipe.spec_for(
            ("experts", "embed", "expert_ffn")),
            (m.n_experts, self.cfg.d_model, m.d_expert), self.sizes, None,
            record=False)
        spec = tuple(spec) + (None,) * (3 - len(spec))
        if "model" in _parts(spec[0]):
            self.moe_split = "experts"
            self.n_experts = m.n_experts // M
            self.expert_start = r * self.n_experts
        elif "model" in _parts(spec[2]):
            self.moe_split = "ffn"
        if m.n_shared_experts:
            ff_sh = m.n_shared_experts * (m.d_shared_expert or m.d_expert)
            self.shared_split = self._over_model(("ffn", "embed"),
                                                 (ff_sh, self.cfg.d_model))

    def _ssm_plan(self, r: int) -> None:
        """The head-aligned Mamba-2 mixer: ``ssm_split`` when the recipe
        puts ``ssm_heads`` and ``ssm_inner`` on ``model``, the SSD heads
        divide and one B/C group serves them all (every config's); this
        rank's heads from ``ssm_head_start``."""
        s, M = self.cfg.ssm, self.model
        self.ssm_split = False
        if s is None:
            return
        d = self.cfg.d_model
        di, nh = s.d_inner(d), s.n_heads(d)
        self._ssm = (di, nh, s.head_dim, s.n_groups, s.d_state)
        rules = self.recipe.rules
        self.ssm_split = (
            M > 1 and _parts(rules.get("ssm_heads")) == ("model",)
            and _parts(rules.get("ssm_inner")) == ("model",)
            and nh % M == 0 and s.n_groups == 1)
        self.ssm_heads = nh // M if self.ssm_split else nh
        self.ssm_head_start = r * self.ssm_heads if self.ssm_split else 0

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
               whole: Tuple[str, ...] = (),
               record: bool = True) -> Tuple[slice, ...]:
        """This rank's block of a leaf with logical ``axes``: the
        recipe's sanitized spec, but the attention heads by the head
        plan, the Mamba-2 mixer by its heads (a dim of ``in_proj`` or
        ``conv`` selects a list of indices, every other dim a slice) and
        the router whole; dims whose logical axis is in ``whole`` stay
        whole. Drops are recorded unless ``record`` is False."""
        axes = tuple(axes or (None,) * len(shape))
        spec = _sanitize(self.recipe.spec_for(axes), tuple(shape),
                         self.sizes, path, record)
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        router = "experts" in axes and "expert_ffn" not in axes
        out = []
        for dim, name, entry in zip(shape, axes, spec):
            if name in whole or (router and name == "experts"):
                out.append(slice(0, dim))
            elif name in ("heads", "kv_heads"):
                out.append(self._head_block(name, dim))
            elif name in ("ssm_heads", "ssm_inner"):
                out.append(self._ssm_block(name, dim))
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

    def _ssm_block(self, name: str, dim: int) -> Union[slice, List[int]]:
        """This rank's heads of a Mamba-2 dim: the ``ssm_heads`` rows,
        or by the dim's size a ``d_inner`` dim (``norm``, ``out_proj``),
        ``conv``'s channels ``[x | B | C]`` or ``in_proj``'s columns
        ``[z | x | B | C | dt]``, each part at this rank's heads and B
        and C whole."""
        if not self.ssm_split:
            return slice(0, dim)
        di, nh, hp, g, N = self._ssm
        h0, h1 = self.ssm_head_start, self.ssm_head_start + self.ssm_heads
        if name == "ssm_heads":
            return slice(h0, h1)
        if dim == di:
            return slice(h0 * hp, h1 * hp)
        inner = list(range(h0 * hp, h1 * hp))
        bc = list(range(di, di + 2 * N))
        if dim == di + 2 * N:
            return inner + bc
        if dim == 2 * di + 2 * N + nh:
            dt = 2 * di + 2 * N
            return (inner + [di + c for c in inner] + [di + c for c in bc]
                    + list(range(dt + h0, dt + h1)))
        raise ValueError(f"an {name} dim of {dim} is none of the Mamba-2 "
                         f"mixer's (d_inner {di}, conv {di + 2 * g * N}, "
                         f"in_proj {2 * di + 2 * g * N + nh})")

    def local_shape(self, axes, shape, path=None,
                    whole: Tuple[str, ...] = ()) -> Tuple[int, ...]:
        return tuple(_extent(s)
                     for s in self.slices(axes, tuple(shape), path, whole))

    def local_spec(self, spec: Dict[str, Tuple], axes: Dict[str, Tuple],
                   whole: Tuple[str, ...] = ()) -> Dict[str, Tuple]:
        """A ``{name: (shape, dtype)}`` spec at this rank's block shapes."""
        return {k: (self.local_shape(axes[k], s, k, whole), d)
                for k, (s, d) in spec.items()}

    # --------------------------------------------------------- every rank
    def peers(self) -> List["Placement"]:
        """The host-only placement of every rank, in rank order (the
        ranks of ``mesh.rank_coords``, or coordinate order for a dict)."""
        if self._peers is None:
            coords = getattr(self.mesh, "rank_coords", None)
            if coords is None:
                names = list(self.sizes)
                coords = [dict(zip(names, c)) for c in itertools.product(
                    *(range(self.sizes[a]) for a in names))]
            self._peers = [Placement(self.cfg, self.recipe, self.sizes, c)
                           for c in coords]
        return self._peers

    def copies(self, axes, shape):
        """How many ranks hold each element of this rank's block. An int
        where blocks are equal or disjoint (every block of a leaf has the
        same count: the world over the number of distinct blocks); where
        a dim selects a list of indices (the Mamba-2 mixer's, whose B/C
        columns every rank holds beside its own heads'), a float tensor
        that broadcasts over the block: each element's holders."""
        shape = tuple(shape)
        mine = self.slices(axes, shape, record=False)
        listed = [i for i, s in enumerate(mine) if not isinstance(s, slice)]
        if not listed:
            blocks = {tuple(_key(s) for s in
                            p.slices(axes, shape, record=False))
                      for p in self.peers()}
            return len(self.peers()) // len(blocks)
        import torch
        (dim,) = listed
        at = {j: n for n, j in enumerate(mine[dim])}
        count = torch.zeros(len(at))
        for p in self.peers():
            theirs = p.slices(axes, shape, record=False)
            if all(_key(a) == _key(b) for i, (a, b) in
                   enumerate(zip(theirs, mine)) if i != dim):
                hit = [at[j] for j in theirs[dim] if j in at]
                count[hit] += 1
        return count.reshape([-1 if i == dim else 1
                              for i in range(len(shape))])

    def owns(self, axes, shape) -> bool:
        """Whether this rank is the first (lowest rank) of those holding
        a block equal to its own: the one that writes it."""
        shape = tuple(shape)
        mine = self.slices(axes, shape, record=False)
        rank = getattr(self.mesh, "rank", 0)
        return next(r for r, p in enumerate(self.peers())
                    if p.slices(axes, shape, record=False) == mine) == rank

    def split_dim(self, axes, shape, axis: str = "data") -> Optional[int]:
        """The dim of a leaf that the recipe splits over mesh axis
        ``axis``, or None when it is whole over it."""
        if self.sizes.get(axis, 1) == 1:
            return None
        axes = tuple(axes or (None,) * len(shape))
        spec = _sanitize(self.recipe.spec_for(axes), tuple(shape),
                         self.sizes, None, record=False)
        for i, entry in enumerate(spec):
            if axis in _parts(entry) and axes[i] not in ("heads",
                                                         "kv_heads"):
                return i
        return None

    def local_to_global(self, block, axes, shape):
        """The whole leaf of ``shape`` from every rank's ``block`` (a
        collective: every rank calls it and gets the whole leaf). Each
        rank's block lands at its own slices: a K/V head or a whole
        attention held by several ranks lands once per holder, so this
        is no concatenation."""
        import torch

        shape = tuple(shape)
        out = torch.empty(shape, dtype=block.dtype, device=block.device)
        for peer, part in zip(self.peers(),
                              self.mesh.world_gather(block)):
            out[peer.slices(axes, shape, record=False)] = part
        return out

    def kv_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """The global ranks that hold one K/V block together: equal
        coordinates on every axis but ``model`` and the same K/V heads
        (2 K/V heads over 4 model ranks: ranks 0-1 and 2-3)."""
        groups: Dict[Tuple, List[int]] = {}
        for r, peer in enumerate(self.peers()):
            key = tuple((a, c) for a, c in sorted(peer.coords.items())
                        if a != "model") + (peer.kv_start,)
            groups.setdefault(key, []).append(r)
        return tuple(tuple(g) for g in groups.values())

    @property
    def kv_shared(self) -> bool:
        """Whether other ranks hold this rank's K/V heads too."""
        return self.heads_split and self.cfg.n_kv_heads < self.model

    # -------------------------------------------------------- collectives
    def reduce_model(self, t):
        """The sum of ``t`` over ``model`` (a row-parallel product): g,
        whose backward is the identity."""
        return self.mesh.sum(t, "model")

    def gather_model(self, t, dim: int):
        """Every ``model`` rank's ``t`` on ``dim`` (the logits over the
        vocabulary); the backward takes this rank's slice of the
        gradient and never sums it: every rank computes the same loss
        from the same gathered tensor."""
        return self.mesh.gather(t, "model", dim)

    def enter_model(self, t):
        """f: ``t`` (whole on every ``model`` rank) entering a split
        region; the backward sums its gradient over ``model``. The
        identity when no gradient is taken."""
        import torch
        if not torch.is_grad_enabled():
            return t
        return self.mesh.enter(t, "model")

    def enter_kv(self, t):
        """f over the ranks that hold this rank's K/V heads (``wk``,
        ``wv``: each holder's gradient carries only its own query heads'
        share)."""
        import torch
        if not (torch.is_grad_enabled() and self.kv_shared):
            return t
        group = self.mesh.subgroup(self.kv_groups())
        return t if group is None else self.mesh.enter(t, group=group)

    def total_model(self, t):
        """The sum of ``t`` over ``model`` whose backward sums too: each
        rank's consumers of the total differ (the gated norm's sum of
        squares over ``d_inner``, each rank normalising its own heads)."""
        return self.mesh.total(t, "model")

    def total_data(self, t):
        """The sum of ``t`` over ``data`` whose backward sums too: a
        statistic of the global batch (the MoE aux loss's means) that
        every data rank computes the same loss from; its gradient is
        then averaged over ``data`` with the others."""
        return self.mesh.total(t, "data")

    def gather_data(self, t, dim: int):
        """A weight split over ``data`` on ``dim``, gathered whole for
        its layer; the backward sums the gradient over ``data`` and
        keeps this rank's block (a reduce-scatter)."""
        return self.mesh.gather(t, "data", dim, reduce=True)

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


def _extent(sel) -> int:
    """The size of one dim's selection: a slice or a list of indices."""
    return sel.stop - sel.start if isinstance(sel, slice) else len(sel)


def _key(sel) -> Tuple:
    return (sel.start, sel.stop) if isinstance(sel, slice) else tuple(sel)


def _key_all(pl: Placement, axes, shape) -> bool:
    """Whether every rank holds the whole leaf."""
    c = pl.copies(axes, shape)
    return isinstance(c, int) and c == len(pl.peers())


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


class TreeLayout:
    """Where every leaf of a tree lives on a mesh: ``axes`` and
    ``shapes`` mirror the tree (each leaf's logical axes and whole
    shape; a leaf with no axes is whole on every rank), ``pl`` is this
    rank's live :class:`Placement`. What a checkpoint reads and writes
    on a mesh."""

    def __init__(self, pl: Placement, axes, shapes):
        self.pl, self.axes, self.shapes = pl, axes, shapes

    @property
    def writer(self) -> bool:
        """Whether this rank writes what the mesh saves (rank 0)."""
        return getattr(self.pl.mesh, "rank", 0) == 0

    def _walk(self, fn, tree, axes, shapes):
        if isinstance(tree, dict):
            return {k: self._walk(fn, tree[k], axes[k], shapes[k])
                    for k in sorted(tree)}
        shape = tuple(shapes)
        return fn(tree, axes or (None,) * len(shape), shape)

    def slices(self):
        """This rank's index tuple of every leaf (``restore_elastic``'s
        ``shardings``)."""
        return self._walk(
            lambda _, ax, shape: self.pl.slices(ax, shape, record=False),
            self.shapes, self.axes, self.shapes)

    def copies(self):
        """How many ranks hold each leaf's block (:meth:`Placement.
        copies`)."""
        return self._walk(lambda _, ax, shape: self.pl.copies(ax, shape),
                          self.shapes, self.axes, self.shapes)

    def blocks(self, tree, path: Tuple[str, ...] = (), axes=None,
               shapes=None):
        """``(keys, block, axes, shape, slices, owned)`` for every leaf
        of ``tree`` (this rank's blocks), in sorted key order: ``slices``
        place the block in the whole leaf of ``shape``, and ``owned`` is
        whether this rank writes it (:meth:`Placement.owns`)."""
        axes = self.axes if axes is None else axes
        shapes = self.shapes if shapes is None else shapes
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from self.blocks(tree[k], path + (k,), axes[k],
                                       shapes[k])
            return
        shape = tuple(shapes)
        ax = axes or (None,) * len(shape)
        yield (path, tree, ax, shape, self.pl.slices(ax, shape, record=False),
               self.pl.owns(ax, shape))

    def barrier(self) -> None:
        """Wait for every rank of the mesh (none on a host-only one)."""
        wait = getattr(self.pl.mesh, "barrier", None)
        if wait is not None:
            wait()

    def gather(self, tree):
        """Every leaf whole, on the host, in ``tree``'s structure (this
        rank's blocks): a collective, leaf by leaf in sorted key order,
        so a rank's device never holds more than one whole leaf."""
        out: Dict[str, Any] = {}
        for keys, block, ax, shape, _, _ in self.blocks(tree):
            block = block.detach()
            if _key_all(self.pl, ax, shape):
                whole = block.to("cpu", copy=True)
            else:
                whole = self.pl.local_to_global(block, ax, shape).cpu()
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = whole
        return out
