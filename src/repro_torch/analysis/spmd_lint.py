"""SPMD/collective lint of the port (counterpart of
``repro.analysis.spmd_lint``): communication and memory pathologies
that only surface on a mesh.

Two evidence sources, the reference's rules:

* **dry-run artifacts** (the port's ``dryrun/<preset>/``, written by
  ``python -m repro_torch.launch.dryrun``): every OK baseline cell's
  per-card collective bytes are gated against the analytic ring-model
  expectation (:func:`expected_collective_bytes`, at :data:`SLACK`),
  and its peak against the closed-form
  :mod:`repro_torch.analysis.capacity` model (``spmd-memory-drift``, at
  :data:`DRIFT_TOL`). The analysis preset ``ci`` reads the dry-run
  preset ``ci``, ``h100`` reads ``full``.
* **fresh traces**: each preset arch's decode step traced on a
  :class:`~repro_torch.launch.mesh.DryMesh` rank of the ``ci`` single
  mesh (every rank of a distinct local shape), its records scanned by
  the rule functions below (a gather of at least :data:`GATHER_FRAC`
  of the parameter bytes; a collective reading the direct result of its
  inverse: a gather's buffer summed, the port's reduce-scatter being an
  all-reduce and a slice, or a just-reduced buffer's slice gathered),
  and its host syncs found by the graph lint's detector (the port's
  counterpart of XLA's host transfers). The rules take records, so each
  is fixture-testable (``tests/test_torch_spmd_lint.py``).

Missing artifacts give an informational ``spmd-lowering-skipped``
instead of a false all-clear.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.analysis.findings import Finding, Location
from repro_torch.analysis.registry import AnalysisContext, register_pass

#: The reference's gates: measured collective bytes over the analytic
#: expectation, |peak - capacity| / peak, and one gather's share of the
#: parameter bytes; below ``MIN_PARAM_BYTES`` of parameters the gather
#: rule is inert (against a smoke-scale tree any routine activation
#: gather would clear the share, and a sub-MB weight gather is not the
#: pathology it names).
SLACK, DRIFT_TOL, GATHER_FRAC, MIN_PARAM_BYTES = 6.0, 0.25, 0.5, 1 << 20

#: A collective whose input a later inverse collective would round-trip:
#: a gathered buffer summed (the port's reduce-scatter is an all-reduce
#: and a slice), a reduced buffer's slice gathered.
_INVERSE_KINDS = {"all-gather": "all-reduce", "all-reduce": "all-gather"}


# ===========================================================================
# Rules over a rank's records (fixture-testable)
# ===========================================================================
def gathered_bytes(rec: Mapping[str, Any]) -> float:
    """The bytes a gather record materializes: every rank's part."""
    return float(rec["bytes"]) * int(rec["n"])


def find_replicated_gathers(records: Sequence[Mapping[str, Any]],
                            param_bytes: float) -> List[Dict[str, Any]]:
    """Gathers whose single result covers :data:`GATHER_FRAC` of the
    *full* parameter tree: the recipe says the weights live sharded, yet
    one collective re-materializes them everywhere. Inert below
    :data:`MIN_PARAM_BYTES` of parameters."""
    if param_bytes < MIN_PARAM_BYTES:
        return []
    hits = []
    for i, r in enumerate(records):
        if r["kind"] != "all-gather":
            continue
        b = gathered_bytes(r)
        if b >= GATHER_FRAC * param_bytes:
            hits.append({**r, "index": i, "gathered": b,
                         "param_frac": b / param_bytes})
    return hits


def find_reshard_thrash(records: Sequence[Mapping[str, Any]]
                        ) -> List[Dict[str, Any]]:
    """A collective reading the direct result of its inverse on the same
    buffer (``src``: the record whose output it reads): a gathered
    buffer summed, or a just-summed buffer's slice gathered. The bytes
    moved twice buy nothing."""
    hits = []
    for i, r in enumerate(records):
        want = _INVERSE_KINDS.get(r["kind"])
        j = r.get("src")
        if want is None or j is None:
            continue
        if records[j]["kind"] == want:
            hits.append({"producer": dict(records[j], index=j),
                         "consumer": dict(r, index=i)})
    return hits


def check_collective_oversize(measured_total: float, expected_total: float
                              ) -> Optional[Dict[str, float]]:
    """Gate measured per-card collective bytes against the analytic
    expectation x :data:`SLACK`; None when inside the budget."""
    if expected_total <= 0 or measured_total <= SLACK * expected_total:
        return None
    return {"measured": measured_total, "expected": expected_total,
            "ratio": measured_total / expected_total}


# ===========================================================================
# Analytic collective expectation (the reference's)
# ===========================================================================
def expected_collective_bytes(cfg, shape, sizes: Dict[str, int]) -> float:
    """Per-card link bytes one step *should* move: per-layer activation
    reductions over the model axis, the sharded-vocab logits reduction,
    gradient sync over data (train), decode attention / SSM-state
    reductions against the live cache window, and the MoE routing-tensor
    reductions. Ring factors via
    :func:`repro_torch.core.hardware.ring_collective_bytes`.

    Deliberately an over-estimate on cells whose sharding avoids a term
    — the lint only fires *above* ``SLACK x expected``, so
    over-prediction is safe."""
    from repro_torch.core.hardware import ring_collective_bytes as ring

    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    ms = sizes.get("model", 1)
    kind = shape.kind
    B = shape.global_batch
    S = 1 if kind == "decode" else shape.seq_len
    tok = B * S
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    bdiv = dp if B % dp == 0 else 1
    mult = 3 if kind == "train" else 1          # fwd + bwd + remat
    kv_len = (getattr(shape, "kv_len", None) or shape.seq_len) \
        if kind == "decode" else S
    W = min(cfg.sliding_window or kv_len, kv_len)
    if cfg.family == "hybrid":
        L_attn, L_ssm = L // cfg.shared_attn_period, L
    elif cfg.family == "ssm":
        L_attn, L_ssm = 0, L
    else:
        L_attn, L_ssm = L, 0

    exp = 0.0
    # per-layer activation psum over the model axis (2 sublayers), f32
    exp += L * 2 * ring(tok * d * 4 / bdiv, ms, "all-reduce") * mult
    # sharded-vocab logits reduction
    exp += ring(tok * V * 4 / bdiv, ms, "all-reduce")
    if kind == "train":
        exp += ring(4 * cfg.param_count() / max(ms, 1), dp, "all-reduce")
    if kind == "decode":
        exp += L_attn * ring(B * cfg.n_heads * W * 4, ms, "all-reduce")
        if cfg.ssm is not None:
            s = cfg.ssm
            nh = d * s.expand // s.head_dim
            exp += L_ssm * ring(B * nh * s.head_dim * s.d_state * 4,
                                ms, "all-reduce")
    if cfg.moe is not None:
        mo = cfg.moe
        cap = math.ceil(mo.capacity_factor * mo.experts_per_token
                        * tok / mo.n_experts)
        exp += L * mult * ring(tok * mo.n_experts * cap * 4 / bdiv,
                               ms, "all-reduce")
    if cfg.ssm is not None and kind != "decode":
        s = cfg.ssm
        d_inner = d * s.expand
        nh = d_inner // s.head_dim
        n_chunks = max(1, S // s.chunk_size)
        st = (B * n_chunks * nh * s.head_dim * s.d_state * 4
              + B * S * d_inner * 4) / bdiv
        exp += L_ssm * mult * ring(st, ms, "all-reduce")
    return exp


# ===========================================================================
# Artifact-cell lint
# ===========================================================================
def lint_artifact_cell(art: Dict[str, Any], launch_preset) -> List[Finding]:
    """Collective-oversize + memory-drift on one OK baseline cell."""
    from repro_torch.analysis.capacity import (capacity_from_artifact,
                                               measured_peak_bytes)

    cell = f"{art['arch']}/{art['shape']}/{art['mesh']}"
    cfg = launch_preset.arch(art["arch"])
    shape = launch_preset.shape(art["shape"])
    findings: List[Finding] = []

    exp = expected_collective_bytes(cfg, shape, art["mesh_axes"])
    over = check_collective_oversize(art["collectives"]["total"], exp)
    if over is not None:
        findings.append(Finding(
            "spmd-collective-oversize", "warning", Location(symbol=cell),
            f"the traced step moves {over['measured'] / 1e6:.1f} MB/card "
            f"of collective traffic, {over['ratio']:.1f}x the analytic "
            f"expectation ({over['expected'] / 1e6:.1f} MB, slack "
            f"{SLACK:g}x) — the step makes communication the recipe "
            f"doesn't account for",
            "diff the cell's collective records against the recipe's "
            "intended resharding points"))

    rep = capacity_from_artifact(art, launch_preset)
    meas = measured_peak_bytes(art["memory"])
    if meas > 0:
        rel = abs(rep.peak_bytes - meas) / meas
        if rel > DRIFT_TOL:
            findings.append(Finding(
                "spmd-memory-drift", "warning", Location(symbol=cell),
                f"the dry-run peak {meas / 1e6:.1f} MB diverges {rel:.0%} "
                f"from the capacity model's {rep.peak_bytes / 1e6:.1f} MB "
                f"(tolerance {DRIFT_TOL:.0%}) — the closed-form model or "
                f"the step changed without recalibration",
                "refit analysis.capacity.CALIBRATION (python -m "
                "repro_torch.analysis.capacity_fit)"))
    return findings


def load_cells(preset_name: str) -> List[Dict[str, Any]]:
    """Every cell of the port's dry-run preset ``preset_name``."""
    from repro_torch.artifacts import dryrun_dir, list_cells

    cells = []
    for name in list_cells(preset_name):
        with open(os.path.join(dryrun_dir(preset_name), name)) as f:
            cells.append(json.load(f))
    return cells


# ===========================================================================
# Fresh-trace lint
# ===========================================================================
def lint_records(records, syncs, *, label: str,
                 param_bytes: float) -> List[Finding]:
    """The three record rules over one traced step; ``syncs`` are its
    host syncs (the graph lint's detector: a value read by the host, a
    data-shaped output, a copy to the host), each ``{what, frame, n}``."""
    findings: List[Finding] = []
    for s in syncs:
        findings.append(Finding(
            "spmd-host-transfer", "error", Location(symbol=label),
            f"{s['n']}x host transfer {s['what']} at {s['frame']} inside "
            f"the step — the card stalls on the host every iteration",
            "keep host I/O outside the step"))
    for r in find_replicated_gathers(records, param_bytes):
        findings.append(Finding(
            "spmd-replicated-gather", "warning", Location(symbol=label),
            f"one all-gather over {r['axis']} (collective {r['index']}) "
            f"materializes {r['gathered'] / 1e6:.1f} MB = "
            f"{r['param_frac']:.0%} of the full parameter tree — the "
            f"recipe's sharding is being undone wholesale",
            "shard the consumer (or use a reduce-scatter layout) "
            "instead of re-gathering the weights"))
    for pair in find_reshard_thrash(records):
        p, c = pair["producer"], pair["consumer"]
        moved = (gathered_bytes(p) if p["kind"] == "all-gather"
                 else p["bytes"]) + c["bytes"]
        findings.append(Finding(
            "spmd-reshard-thrash", "warning", Location(symbol=label),
            f"{c['kind']} over {c['axis']} (collective {c['index']}) "
            f"reads the direct result of its inverse {p['kind']} "
            f"(collective {p['index']}) — {moved / 1e6:.1f} MB reshard "
            f"round-trip on one buffer",
            "keep the producer's layout where the consumer reads it"))
    return findings


def lint_fresh_traces(ctx: AnalysisContext) -> List[Finding]:
    """Trace each preset arch's decode step on the ``ci`` single mesh
    (every rank of a distinct local shape) and scan its records."""
    from repro_torch.analysis.capacity import params_bytes
    from repro_torch.kernels.dispatch import CUDA_POLICY
    from repro_torch.dist.sharding import default_recipe
    from repro_torch.launch.lowering import trace_ranks, unique_traces
    from repro_torch.launch.presets import CI
    from repro_torch.models.model import ModelRuntime

    findings: List[Finding] = []
    spec = CI.mesh_spec("single")
    shape = CI.shape("decode_32k")
    rt = ModelRuntime(dtype="bfloat16", remat="none", attn_chunk=512,
                      moe_dropless=True, kernels=CUDA_POLICY, device="meta")
    for arch in ctx.preset.archs:
        cfg = CI.arch(arch)
        if cfg.is_encoder_only:
            continue
        recipe = default_recipe(cfg, shape.kind, spec.axis_sizes()["model"])
        pbytes = params_bytes(cfg, "bfloat16")
        for t in unique_traces(trace_ranks(cfg, shape, spec, recipe, rt)):
            label = (f"decode/{arch}@{'x'.join(map(str, spec.shape))}"
                     f"/rank{t['rank']}")
            findings.extend(lint_records(
                t["records"], t["syncs"], label=label, param_bytes=pbytes))
    return findings


# ===========================================================================
# Pass
# ===========================================================================
@register_pass(
    "spmd_lint",
    rules=("spmd-collective-oversize", "spmd-replicated-gather",
           "spmd-reshard-thrash", "spmd-host-transfer",
           "spmd-memory-drift", "spmd-lowering-skipped"),
    description="collective-bytes/memory gates over the port's dry-run "
                "artifacts + record lint of freshly traced decode steps "
                "on a DryMesh")
def run_pass(ctx: AnalysisContext) -> List[Finding]:
    from repro_torch.launch.presets import get_preset

    findings: List[Finding] = []
    preset_name = ctx.preset.dryrun_preset
    launch_preset = get_preset(preset_name)
    linted = 0
    for art in load_cells(preset_name):
        if art.get("status") != "OK" \
                or art.get("variant", "baseline") != "baseline":
            continue
        findings.extend(lint_artifact_cell(art, launch_preset))
        linted += 1
    if linted == 0:
        findings.append(Finding(
            "spmd-lowering-skipped", "info", Location(symbol="spmd_lint"),
            f"no '{preset_name}' dry-run artifacts found — collective/"
            f"memory gates skipped (generate with python -m "
            f"repro_torch.launch.dryrun --preset {preset_name})"))
    findings.extend(lint_fresh_traces(ctx))
    return findings
