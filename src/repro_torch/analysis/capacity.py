"""Closed-form HBM capacity model of the port: one step's argument
residency and peak on each device, predicted before anything is
allocated.

The counterpart of ``repro.analysis.capacity``. It predicts the bytes
of one train / prefill / decode step on one card, or on each rank of a
mesh, from pure shape math — no allocation, no device — and has two
consumers here:

* ``launch/serve.py --preflight`` — reject an oversized serving config
  (``n_slots``/``max_len``/page budget beyond the card) before anything
  is allocated, naming ``capacity-hbm-overflow``;
* ``chip_smoke.py`` — every served, prefilled and trained run on the
  card holds this prediction against ``torch.cuda.max_memory_allocated``,
  each rank of a sharded engine included.

The argument model is *exact* against the port's own allocations: the
parameters per ``param_defs`` at the runtime's dtype with the
``F32_LEAVES`` in f32 (``cast_params``); a train step's f32 masters,
AdamW's two moments and its int32 step; the decode cache per
``cache_spec``/``paged_cache_spec``; the batch as the reference counts
it. Two differences from the reference, both the port's own layout: the
norm scales, router and SSM leaves stay f32 in a bf16 runtime, and a
prefill holds the token table whatever the front end (the reference's
XLA prunes it when embeddings feed in).

The peak is a linear model of per-kind features, the reference's
``_peak_features`` at one device plus the port's own ``prefill_cache``
(an eager prefill returns the cache it fills), with coefficients fitted
by nnls on the card (:data:`CALIBRATION`). The reference's
coefficients, fitted on XLA's ``memory_analysis`` where a decode step
keeps ~2.4 copies of its weights, are :data:`XLA_CALIBRATION`; only the
CPU test that holds this formula to the reference's uses them.

On a mesh every byte count is per device: each leaf at the block of it
a rank holds (``dist.sharding.Placement``, the blocks the sharded
engines allocate), which is the reference's ``sanitize_spec`` division
except for the attention heads, where a rank holds the K/V heads its
query heads read (``tests/test_torch_sharding.py`` pins the leaves
where the two differ); :func:`shard_factor` and :func:`sharded_bytes`
are the reference's spec division, which the batch follows. The
dry-run artifact parity (:func:`capacity_from_artifact`,
:func:`measured_peak_bytes`) holds this model to the port's dry-run
cells (``launch.dryrun``), as the ``spmd_lint`` pass reads them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.hardware import H100_SXM
from repro_torch.dist.sharding import (RECIPES, Placement, Recipe,
                                       default_recipe, get_recipe,
                                       sanitize_spec)
from repro_torch.dist.sharding import mesh_sizes as _sizes
from repro_torch.models.model import (CACHE_AXES, F32_LEAVES,
                                      PAGED_CACHE_AXES, ModelRuntime,
                                      _cache_window, axes_tree, cache_spec,
                                      page_count, paged_cache_spec,
                                      param_defs, torch_dtype)

#: KV-chunk length the reference's prefill/train scores feature is taken
#: at (its ModelRuntime's default ``attn_chunk``, the port's too).
ATTN_CHUNK = 512

#: The reference's per-kind coefficients, fitted (nnls, relative-error
#: weighted) against the 64 OK ci dry-run cells of XLA's
#: ``memory_analysis``; ``one`` is a constant offset in units of 1e6
#: bytes. Not the card's: the CPU parity test alone reads them.
XLA_CALIBRATION: Dict[str, Dict[str, float]] = {
    "decode": {"params": 2.482, "cache": 2.333, "cache_allsh": 0.249,
               "kv_ms": 1.551},
    "prefill": {"scores": 1.473, "moe": 2.330, "ssm": 0.046,
                "act": 1.935, "one": 3.261},
    "train": {"params": 21.772, "scores": 4.501, "moe": 3.033,
              "ssm": 10.441, "logits": 1.942},
}

#: The card's per-kind coefficients: nnls, weighted by relative error,
#: over the features of :data:`FIT_FEATURES`, against the peaks
#: ``chip_smoke.py`` measured on one NVIDIA H100 80GB HBM3 at a 700 W
#: power limit (its ``[capacity]`` lines: 27 engine runs of the nine
#: served decoders, 8 prefills, 6 training runs), fitted by ``python -m
#: repro_torch.analysis.capacity_fit``. ``one`` is in units of 1e6 bytes.
CALIBRATION: Dict[str, Dict[str, float]] = {
    "decode": {"params": 1.0031, "cache": 1.2263, "kv_ms": 0.0665,
               "one": 80.826},
    "prefill": {"params": 1.0039, "prefill_cache": 0.944, "act": 4.7372,
                "logits": 0.1079, "ssm": 2.5405},
    "train": {"params": 3.6407, "scores": 79.8255, "moe": 63.2169,
              "ssm": 243.369, "one": 456.1803},
}

#: The features each kind's card coefficients are fitted over.
FIT_FEATURES: Dict[str, Tuple[str, ...]] = {
    "decode": ("params", "cache", "kv_ms", "one"),
    "prefill": ("params", "prefill_cache", "act", "logits", "moe", "ssm",
                "one"),
    "train": ("params", "act", "logits", "scores", "moe", "ssm", "one"),
}

#: The dry-run's per-kind coefficients: the reference's recipe (nnls,
#: weighted by relative error) over :data:`DRYRUN_FEATURES`, against the
#: storage walk's peaks of the 64 OK ``ci`` cells of both meshes
#: (``python -m repro_torch.analysis.capacity_fit --dryrun``). What
#: :func:`capacity_from_artifact` predicts a dry-run cell with; the
#: card's :data:`CALIBRATION`, whose fixed offsets dwarf a smoke-scale
#: cell, stays the serving preflight's and the card checks'.
DRYRUN_CALIBRATION: Dict[str, Dict[str, float]] = {
    "decode": {"params": 1.2929, "cache": 0.8979, "kv_ms": 0.0802,
               "one": 0.0063},
    "prefill": {"params": 4.4832, "logits": 1.5302, "moe": 0.0233,
                "ssm": 0.3938},
    "train": {"logits": 1.3181, "scores": 2.5082, "ssm": 1.0706,
              "one": 12.7709},
}

#: The features each kind's dry-run coefficients are fitted over: the
#: card's and the reference's together.
DRYRUN_FEATURES: Dict[str, Tuple[str, ...]] = {
    "decode": ("params", "cache", "cache_allsh", "kv_ms", "one"),
    "prefill": ("params", "prefill_cache", "act", "logits", "scores", "moe",
                "ssm", "one"),
    "train": ("params", "act", "logits", "scores", "moe", "ssm", "one"),
}

CALIBRATION_VERSION = 1

#: The acceptance bar of a prediction against a measured peak, per run.
PARITY_REL_TOL = 0.25

#: One device.
ONE_DEVICE = {"data": 1, "model": 1}


# ===========================================================================
# Sharded byte accounting
# ===========================================================================
def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis-name -> size of a dict or of the port's ``launch.mesh.Mesh``;
    ``None`` -> one device."""
    return dict(ONE_DEVICE) if mesh is None else _sizes(mesh)


def shard_factor(spec, shape: Tuple[int, ...],
                 sizes: Dict[str, int]) -> int:
    """How many ways ``sanitize_spec`` divides ``shape`` (the reference's
    division, the divisibility and reuse drops included)."""
    f = 1
    for e in sanitize_spec(spec, shape, sizes):
        for ax in ((e,) if isinstance(e, str) else e or ()):
            f *= sizes[ax]
    return f


def sharded_bytes(shape: Tuple[int, ...], itemsize: int, spec,
                  sizes: Dict[str, int]) -> int:
    n = math.prod(shape) if shape else 1
    return (n // shard_factor(spec, shape, sizes)) * itemsize


def _leaves(tree, axes, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, axes[k], path + (k,))
    else:
        yield path, tree, axes


def tree_sharded_bytes(tree, axes, recipe: Recipe, sizes: Dict[str, int],
                       cfg: ModelConfig, itemsize=None) -> int:
    """Per-device bytes of a tree of ``{name: (shape, dtype)}`` entries
    or ``ParamDef`` leaves, ``axes`` its logical-axes tree: each leaf at
    the block a rank of the port holds
    (:class:`~repro_torch.dist.sharding.Placement`). ``itemsize(path,
    leaf)`` overrides a leaf's element size."""
    pl = Placement(cfg, recipe, sizes)
    total = 0
    for path, leaf, ax in _leaves(tree, axes):
        shape, dtype = (tuple(leaf.shape), None) if hasattr(leaf, "shape") \
            else (tuple(leaf[0]), leaf[1])
        item = itemsize(path, leaf) if itemsize is not None \
            else _itemsize(dtype)
        ax = ax or (None,) * len(shape)
        total += math.prod(pl.local_shape(ax, shape)) * item
    return total


# ===========================================================================
# The exact argument model
# ===========================================================================
def _itemsize(dtype) -> int:
    return int(dtype.itemsize)


def params_bytes(cfg: ModelConfig, dtype: str = "bfloat16", mesh=None,
                 recipe: Optional[Recipe] = None) -> int:
    """Bytes of the parameter tree as ``cast_params`` holds it at
    ``dtype``: every leaf in ``dtype`` but the :data:`F32_LEAVES`, f32;
    per device on ``mesh`` under ``recipe`` (default ``decode``)."""
    item, f32 = _itemsize(torch_dtype(dtype)), 4

    def size(path, leaf) -> int:
        return f32 if any(p in F32_LEAVES for p in path) else item

    return tree_sharded_bytes(param_defs(cfg), axes_tree(cfg),
                              recipe or RECIPES["decode"], mesh_sizes(mesh),
                              cfg, itemsize=size)


def spec_bytes(spec) -> int:
    """Bytes of a ``{name: (shape, dtype)}`` cache spec."""
    return sum(math.prod(s) * _itemsize(d) for s, d in spec.values())


#: Input batches are sharded over (pod, data) on dim 0, as the
#: reference counts them.
_BATCH_SPEC = ("pod", "data")


def _batch_bytes(cfg: ModelConfig, B: int, S: int, kind: str,
                 sizes: Optional[Dict[str, int]] = None) -> int:
    """The step's inputs, as the reference counts them: (B,) int32 tokens
    at decode; (B, S) int32 tokens or (B, S, d) bf16 embeddings, plus
    (B, S) int32 labels in training; per device over ``data``."""
    sizes = sizes or dict(ONE_DEVICE)
    if kind == "decode":
        return sharded_bytes((B,), 4, (_BATCH_SPEC,), sizes)
    if cfg.frontend == "token":
        total = sharded_bytes((B, S), 4, (_BATCH_SPEC, None), sizes)
    else:
        total = sharded_bytes((B, S, cfg.d_model), 2,
                              (_BATCH_SPEC, None, None), sizes)
    if kind == "train":
        total += sharded_bytes((B, S), 4, (_BATCH_SPEC, None), sizes)
    return total


#: KV-cache leaves (payload + int8 scale side-bands).
KV_LEAVES = ("k", "v", "kp", "vp", "ks", "vs")


# ===========================================================================
# Peak-model features
# ===========================================================================
def _peak_features(cfg: ModelConfig, B: int, S: int, kind: str,
                   sizes: Optional[Dict[str, int]] = None
                   ) -> Dict[str, float]:
    """The reference's ``_peak_features``: per device, the batch divided
    over ``data`` where it divides, the scores' heads over ``model``."""
    sizes = sizes or dict(ONE_DEVICE)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    ms = sizes.get("model", 1)
    H = cfg.n_heads
    bdiv = dp if B % dp == 0 else 1
    hdiv = ms if H % ms == 0 else 1
    tok = B * S
    attn = cfg.family in ("dense", "moe", "vlm", "audio", "hybrid")
    f: Dict[str, float] = {"one": 1e6}
    f["act"] = tok * cfg.d_model * 4 / bdiv
    f["scores"] = (B * H * S * min(S, ATTN_CHUNK) * 4 / (bdiv * hdiv)
                   if attn and kind != "decode" else 0.0)
    f["logits"] = tok * cfg.vocab_size * 4 / bdiv
    if cfg.moe is not None and kind != "decode":
        E = cfg.moe.n_experts
        cap = math.ceil(cfg.moe.capacity_factor
                        * cfg.moe.experts_per_token * tok / E)
        f["moe"] = (tok / bdiv) * E * cap * 4
    else:
        f["moe"] = 0.0
    if cfg.ssm is not None and kind != "decode":
        s = cfg.ssm
        d_inner = cfg.d_model * s.expand
        n_heads = d_inner // s.head_dim
        n_chunks = max(1, S // s.chunk_size)
        f["ssm"] = (B * n_chunks * n_heads * s.head_dim * s.d_state * 4
                    + B * S * d_inner * 4) / bdiv
    else:
        f["ssm"] = 0.0
    return f


def predicted_peak(features: Dict[str, float],
                   coefficients: Dict[str, float], floor: int) -> int:
    """The linear peak, never below the exact argument bytes ``floor``
    (what provably resides)."""
    peak = sum(c * features.get(k, 0.0) for k, c in coefficients.items())
    return max(int(round(peak)), int(floor))


# ===========================================================================
# CapacityReport + capacity()
# ===========================================================================
@dataclass(frozen=True)
class CapacityReport:
    """Per-device HBM accounting of one step, from pure shape math."""

    kind: str                       # train | prefill | decode
    argument_bytes: int             # exact (the port's allocations)
    peak_bytes: int                 # calibrated prediction
    params_bytes: int               # at the step's param dtype
    cache_bytes: int                # KV/state cache (decode only)
    batch_bytes: int
    hbm_bytes: int                  # the card's budget gated against
    fits: bool
    utilization: float              # peak / hbm
    features: Dict[str, float] = field(default_factory=dict)
    coefficients: Dict[str, float] = field(default_factory=dict)
    notes: Tuple[str, ...] = ()
    recipe: str = "decode"
    mesh_sizes: Dict[str, int] = field(
        default_factory=lambda: dict(ONE_DEVICE))
    devices: int = 1

    def to_json(self) -> Dict[str, Any]:
        return {
            "calibration_version": CALIBRATION_VERSION,
            "kind": self.kind, "recipe": self.recipe,
            "mesh_sizes": dict(self.mesh_sizes), "devices": self.devices,
            "argument_bytes": self.argument_bytes,
            "peak_bytes": self.peak_bytes,
            "params_bytes": self.params_bytes,
            "cache_bytes": self.cache_bytes,
            "batch_bytes": self.batch_bytes,
            "hbm_bytes": self.hbm_bytes, "fits": self.fits,
            "utilization": round(self.utilization, 4),
            "features": {k: float(v) for k, v in self.features.items()},
            "notes": list(self.notes),
        }


def capacity(cfg: ModelConfig, shape: Optional[ShapeConfig] = None,
             mesh=None, recipe=None, *,
             n_slots: Optional[int] = None,
             page_budget: Optional[int] = None,
             page_size: int = 8,
             max_len: Optional[int] = None,
             chip=None,
             dtype: str = "bfloat16",
             param_dtype: Optional[str] = None,
             kv_dtype: Optional[str] = None,
             calibration: Optional[Dict[str, Dict[str, float]]] = None,
             ) -> CapacityReport:
    """Predict one step's HBM residency and peak on each device.

    Either pass a ``ShapeConfig`` (``shape``) or describe a serving
    config with ``n_slots`` + ``max_len`` (contiguous cache) and
    optionally ``page_budget``/``page_size`` (paged pool); the serving
    forms imply ``kind='decode'``. ``mesh`` is a dict of axis sizes, the
    port's ``Mesh`` or ``None`` (one device); ``recipe`` a ``Recipe``, a
    recipe name or ``None`` for the reference launcher's
    (``dist.sharding.default_recipe``). ``dtype`` is the runtime's activation
    dtype (the cache's, unless ``kv_dtype`` overrides its K/V);
    ``param_dtype`` defaults to f32 for training (the masters) and to
    ``dtype`` otherwise. ``chip`` is a spec with ``hbm_bytes`` or a byte
    count (default :data:`~repro_torch.core.hardware.H100_SXM`);
    ``calibration`` defaults to the card's :data:`CALIBRATION`.
    """
    sizes = mesh_sizes(mesh)
    devices = math.prod(sizes.values())
    notes: list = []
    if shape is None:
        if n_slots is None or max_len is None:
            raise ValueError("pass a ShapeConfig, or n_slots= + max_len= "
                             "for a serving config")
        shape = ShapeConfig(name=f"serve_{n_slots}x{max_len}",
                            seq_len=1, global_batch=int(n_slots),
                            kind="decode", kv_len=int(max_len))
    kind = shape.kind
    if recipe is None:
        recipe = default_recipe(cfg, kind, sizes.get("model", 1))
    elif isinstance(recipe, str):
        recipe = get_recipe(recipe)
    B, S = shape.global_batch, shape.seq_len
    if param_dtype is None:
        param_dtype = "float32" if kind == "train" else dtype
    pb = params_bytes(cfg, param_dtype, sizes, recipe)
    batch_b = _batch_bytes(cfg, B, S, kind, sizes)
    pl = Placement(cfg, recipe, sizes)

    def local(spec, axes, whole=()):
        return spec_bytes(pl.local_spec(spec, axes, whole))

    feats = _peak_features(cfg, B, S, kind, sizes)
    cache_b = 0
    kv_b = 0
    cache_global = 0
    if kind == "train":
        # f32 masters + AdamW's two moments + its int32 step
        args = pb * 3 + 4 + batch_b
    elif kind == "prefill":
        args = pb + batch_b
        # the cache the prefill returns (a feature, not an argument):
        # every row, this rank's heads
        feats["prefill_cache"] = float(local(cache_spec(
            cfg, B, shape.kv_len or S, dtype, kv_dtype), CACHE_AXES,
            ("batch",)))
    else:
        kv_len = shape.kv_len or shape.seq_len
        if page_budget is not None:
            cs = paged_cache_spec(cfg, B, page_budget, page_size, kv_len,
                                  dtype, kv_dtype)
            axes = PAGED_CACHE_AXES
            notes.append(f"paged cache: {page_budget} pages x "
                         f"{page_size} tokens")
        else:
            cs = cache_spec(cfg, B, kv_len, dtype, kv_dtype)
            axes = CACHE_AXES
        if kv_dtype is not None and kv_dtype != dtype:
            notes.append(f"kv_dtype={kv_dtype}")
        cache_b = local(cs, axes)
        cache_global = spec_bytes(cs)
        kv_b = local({k: v for k, v in cs.items() if k in KV_LEAVES}, axes)
        args = pb + cache_b + batch_b
    feats["params"] = float(pb)
    # the reference's sharded and all-shard cache bytes; K/V as a rank
    # holds it (the card's coefficients were fitted on one device's)
    feats["cache"] = float(cache_b)
    feats["cache_allsh"] = cache_global / devices
    feats["kv_ms"] = float(kv_b)

    coef = dict((calibration or CALIBRATION)[kind])
    peak = predicted_peak(feats, coef, args)
    chip = H100_SXM if chip is None else chip
    hbm = int(chip) if isinstance(chip, (int, float)) \
        else int(chip.hbm_bytes)
    return CapacityReport(
        kind=kind, argument_bytes=int(args), peak_bytes=peak,
        params_bytes=int(pb), cache_bytes=int(cache_b),
        batch_bytes=int(batch_b), hbm_bytes=hbm, fits=peak <= hbm,
        utilization=peak / hbm, features=feats, coefficients=coef,
        notes=tuple(notes), recipe=recipe.name, mesh_sizes=sizes,
        devices=devices)


# ===========================================================================
# Dry-run artifact parity (the spmd-memory-drift entry)
# ===========================================================================
def measured_peak_bytes(mem: Dict[str, int]) -> int:
    """The per-device peak a dry-run cell records: its ``peak_bytes``
    (the port's storage walk)."""
    return int(mem["peak_bytes"])


def capacity_from_artifact(art: Dict[str, Any], preset) -> CapacityReport:
    """Re-derive the cell's capacity prediction from its identity fields
    (arch/shape/mesh_axes; ``preset`` a ``launch.presets.Preset``) under
    :data:`DRYRUN_CALIBRATION`: baseline-variant cells only."""
    cfg = preset.arch(art["arch"])
    shape = preset.shape(art["shape"])
    return capacity(cfg, shape, mesh=art["mesh_axes"],
                    calibration=DRYRUN_CALIBRATION)


# ===========================================================================
# Serving preflight (launch/serve.py --preflight)
# ===========================================================================
def default_page_budget(cfg: ModelConfig, n_slots: int, max_len: int,
                        page_size: int, dtype: str = "bfloat16",
                        kv_dtype: Optional[str] = None) -> int:
    """The pool ``PagedServeEngine`` allocates when no budget is given:
    the contiguous engine's K/V bytes at ``dtype``, in pages of
    ``kv_dtype`` (``serve.paged.equal_hbm_pages``), null page included."""
    from repro_torch.serve.paged import equal_hbm_pages
    rt = ModelRuntime(dtype=dtype, kv_dtype=kv_dtype, device="cpu")
    npp = page_count(_cache_window(cfg, max_len), page_size)
    return equal_hbm_pages(cfg, rt, n_slots, npp)


def serve_preflight(cfg: ModelConfig, *, n_slots: int, max_len: int,
                    page_size: Optional[int] = None,
                    page_budget: Optional[int] = None,
                    mesh=None, hbm_gb: Optional[float] = None,
                    dtype: str = "bfloat16",
                    param_dtype: Optional[str] = None,
                    kv_dtype: Optional[str] = None,
                    recipe="decode") -> CapacityReport:
    """The serve launcher's capacity gate, evaluated before anything is
    allocated, at the runtime's ``dtype`` (and ``param_dtype``, default
    ``dtype``) that the engine then runs, per device on ``mesh`` under
    ``recipe`` (a ``Recipe`` or its name; default ``decode``, the
    sharded engines' default). A paged config without a budget gates the
    pool ``PagedServeEngine`` derives (:func:`default_page_budget`).
    ``hbm_gb`` (GiB) overrides each card's budget."""
    chip: Any = None
    if hbm_gb is not None:
        chip = int(hbm_gb * 2**30)
    kw = dict(mesh=mesh, recipe=recipe, n_slots=n_slots, max_len=max_len,
              chip=chip, dtype=dtype, param_dtype=param_dtype,
              kv_dtype=kv_dtype)
    if page_size:
        if page_budget is None:
            page_budget = default_page_budget(cfg, n_slots, max_len,
                                              page_size, dtype, kv_dtype)
        return capacity(cfg, page_budget=page_budget, page_size=page_size,
                        **kw)
    return capacity(cfg, **kw)
