"""Static sharding propagation of the port (counterpart of
``repro.analysis.sharding_prop``): every recipe's specs pushed over the
paper-scale parameter and cache trees on the reference's production
meshes. Shape math only: no device, no process group.

``sanitize_spec`` degrades an infeasible sharding to replication by
design, which is right at run time and wrong when silent: a head count
that stops dividing the model axis replicates a multi-GiB leaf on every
device, and nothing fails until memory does. This pass replays the
port's own placement at full scale, where the smoke-size tests cannot
see the divisibility failures:

* ``shard-unknown-mesh-axis`` (error): a recipe rule of
  ``dist.sharding.RECIPES`` names a mesh axis no mesh of :data:`MESHES`
  has; the spec is dead everywhere.
* ``shard-replicated-large`` (warning; info for the paged pool, which
  no paper-scale launch allocates): a leaf above the preset's byte
  floor that a rank holds whole although the recipe asked to split it.
  Read from the port's own bytes, :meth:`Placement.local_shape`, not
  from the spec: where the port departs from the spec (each rank holds
  the K/V heads its query heads read, the Mamba-2 mixer's head-aligned
  columns, the router whole) the bytes are what a rank really holds.
* ``shard-spec-dropped`` (info): per (arch x mesh x step) cell, how many
  requested mesh axes ``sanitize_spec`` dropped for indivisibility, with
  example leaves; the same drops, leaf for leaf, as the reference's.

The cells are the reference's: every arch at full width, the meshes of
its ``full`` launch preset (:data:`MESHES`), one shape per step kind,
``default_recipe`` choosing the recipe and ``shape_skip_reason``
excluding the same cells.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

from repro_torch.analysis.findings import Finding, Location
from repro_torch.analysis.registry import AnalysisContext, register_pass

#: One shape per step kind, from the paper's grid.
_KIND_SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
                "decode": "decode_32k"}

#: The reference's ``full`` launch meshes (``repro.launch.presets.FULL``),
#: axis -> size, under the same names: the port has no launch presets,
#: and keeping these meshes holds its findings to the reference's.
MESHES: Dict[str, Dict[str, int]] = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}

#: Bytes of one element of the serving and the training trees.
_ITEMSIZE = {"bfloat16": 2, "float32": 4}


# ===========================================================================
# Recipe rule audit (mesh-independent)
# ===========================================================================
def known_mesh_axes() -> Tuple[str, ...]:
    """Every mesh axis of :data:`MESHES`, in first-seen order."""
    axes: List[str] = []
    for sizes in MESHES.values():
        axes.extend(a for a in sizes if a not in axes)
    return tuple(axes)


def find_unknown_axes() -> List[Finding]:
    """A finding for every rule of a recipe of ``RECIPES`` that names a
    mesh axis no mesh has."""
    from repro_torch.dist import sharding

    known = set(known_mesh_axes())
    findings = []
    for rname, recipe in sorted(sharding.RECIPES.items()):
        for logical, entry in sorted(recipe.rules.items()):
            for ax in sharding._parts(entry):
                if ax not in known:
                    findings.append(Finding(
                        "shard-unknown-mesh-axis", "error",
                        Location(symbol=f"recipe/{rname}/{logical}"),
                        f"recipe {rname!r} maps logical axis "
                        f"{logical!r} to mesh axis {ax!r}, which exists "
                        f"in no mesh ({sorted(known)}) — the spec "
                        f"silently replicates everywhere",
                        "fix the axis name or add it to a mesh"))
    return findings


# ===========================================================================
# Per-cell propagation
# ===========================================================================
def _leaves(tree, axes, itemsize: int,
            path: str = "") -> Iterator[Tuple[str, Tuple, Tuple, int]]:
    """(path, shape, logical axes, bytes per element) of every leaf of a
    tree of ``ParamDef``s (``itemsize`` each) or of ``(shape, dtype)``
    specs (``itemsize`` 0: the dtype's), in sorted key order (the
    reference's tree order), paths as ``"['a']['b']"``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], axes[k], itemsize, f"{path}['{k}']")
        return
    if itemsize:
        shape = tuple(tree.shape)
    else:
        shape, itemsize = tuple(tree[0]), tree[1].itemsize
    yield path, shape, tuple(axes or (None,) * len(shape)), itemsize


def cell_trees(cfg, kind: str, shape) -> List[Tuple[str, Dict, Dict, int]]:
    """[(label, tree, axes, itemsize)]: the trees a step of ``kind``
    places on its devices. Parameters in f32 for training, bf16
    otherwise (every leaf, as the reference counts them); at decode the
    contiguous cache and, but for the ``ssm`` family, a paged pool at
    page 64 with a page table's worth of pages for every slot plus the
    null page, each leaf in its own dtype (``itemsize`` 0)."""
    from repro_torch.models.model import (CACHE_AXES, PAGED_CACHE_AXES,
                                          _cache_window, axes_tree,
                                          cache_spec, page_count,
                                          paged_cache_spec, param_defs)

    dtype = "float32" if kind == "train" else "bfloat16"
    trees = [("params", param_defs(cfg), axes_tree(cfg), _ITEMSIZE[dtype])]
    if kind == "decode":
        B = shape.global_batch
        kv_len = shape.kv_len or shape.seq_len
        spec = cache_spec(cfg, B, kv_len, whole_batch=True)
        trees.append(("cache", spec, {k: CACHE_AXES[k] for k in spec}, 0))
        if cfg.family != "ssm":
            page_size = 64
            pages = B * page_count(_cache_window(cfg, kv_len), page_size) + 1
            spec = paged_cache_spec(cfg, B, pages, page_size, kv_len)
            trees.append(("paged_cache", spec,
                          {k: PAGED_CACHE_AXES[k] for k in spec}, 0))
    return trees


def propagate_cell(cfg, mesh_name: str, sizes: Dict[str, int], kind: str,
                   shape, *, replicated_floor: int,
                   seen: set) -> List[Finding]:
    """The cell's recipe over its trees: a ``shard-replicated-large``
    finding per leaf past ``replicated_floor`` that a rank holds whole
    though the recipe asked to split it, and one ``shard-spec-dropped``
    rollup of the cell's ``indivisible`` drops."""
    from repro_torch.dist.sharding import (Placement, _extent,
                                           default_recipe,
                                           reset_spec_drops, sanitize_spec,
                                           spec_drop_count, spec_drops)

    recipe = default_recipe(cfg, kind, sizes.get("model", 1))
    pl = Placement(cfg, recipe, sizes)
    devices = math.prod(sizes.values())
    cell = f"{cfg.name}/{mesh_name}/{kind}"
    findings: List[Finding] = []

    reset_spec_drops()
    for label, tree, axes, itemsize in cell_trees(cfg, kind, shape):
        for path, shp, ax, item in _leaves(tree, axes, itemsize):
            spec = recipe.spec_for(ax)
            sanitize_spec(spec, shp, sizes, path=f"{label}{path}")
            local = tuple(_extent(s) for s in pl.slices(ax, shp,
                                                        record=False))
            leaf_bytes = math.prod(shp) * item
            wanted = any(e is not None for e in spec)
            key = (cfg.name, mesh_name, recipe.name, label, path)
            if (local == shp and wanted and leaf_bytes >= replicated_floor
                    and key not in seen):
                seen.add(key)
                # the paged pool is sized here for accounting only: no
                # paper-scale launch allocates one (the engine's pool is
                # sized by --preflight against HBM)
                sev = "info" if label == "paged_cache" else "warning"
                findings.append(Finding(
                    "shard-replicated-large", sev,
                    Location(symbol=f"{cell}/{label}{path}"),
                    f"{leaf_bytes / 2**30:.2f} GiB leaf stays whole on "
                    f"each of the {devices} devices: recipe "
                    f"{recipe.name!r} requested {spec!r}, but the "
                    f"placement splits no dim of shape {shp}",
                    "pick a recipe whose axes divide this shape (the "
                    "*_seq variants), or reshape the tensor"))

    dropped = spec_drop_count("indivisible")
    if dropped:
        ex = [f"{d.path}[{d.axis} vs dim {d.dim}]"
              for d in spec_drops() if d.reason == "indivisible"][:3]
        findings.append(Finding(
            "shard-spec-dropped", "info", Location(symbol=cell),
            f"{dropped} requested mesh axes dropped for indivisibility "
            f"under recipe {recipe.name!r} (silent replication), e.g. "
            f"{'; '.join(ex)}"))
    return findings


@register_pass(
    "sharding_prop",
    rules=("shard-replicated-large", "shard-spec-dropped",
           "shard-unknown-mesh-axis"),
    description="propagate the recipes' specs over paper-scale "
                "param/cache trees on the reference's production meshes")
def run_pass(ctx: AnalysisContext) -> List[Finding]:
    from repro_torch.configs import ARCHS, get_shape
    from repro_torch.configs.base import shape_skip_reason

    findings = find_unknown_axes()
    seen: set = set()
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch]
        for kind, shape_name in _KIND_SHAPES.items():
            shape = get_shape(shape_name)
            if shape_skip_reason(cfg, shape):
                continue
            for mesh_name, sizes in MESHES.items():
                findings.extend(propagate_cell(
                    cfg, mesh_name, sizes, kind, shape,
                    replicated_floor=ctx.preset.replicated_leaf_bytes,
                    seen=seen))
    return findings
