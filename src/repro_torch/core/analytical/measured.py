"""Measured-latency accelerator model: workloads priced from kernel
timings instead of formulas.

The port's copy of the reference's ``repro.core.analytical.measured``.
:class:`MeasuredModel` looks each op of a Workload up in the calibration
the port's tuner (``repro_torch.kernels.tune``) measured on the card:
an op within :data:`MEASURED_MATCH_FACTOR` in FLOPs of a measured entry
of its kind scales that entry's time; any other op is
roofline-interpolated from the kind's achieved FLOP/s and byte/s rates.
The calibration's schema is the reference's (``ENTRY_FIELDS``, version
2), so either tuner's payload loads here. The efficiency is taken
against the card's peak (``H100_SXM`` by default), not a TPU's.

Pure table arithmetic: no framework import.
"""
from __future__ import annotations

import json
import math
import os
import statistics
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.artifacts import calibration_path
from repro_torch.core.analytical.interface import EvalResult
from repro_torch.core.hardware import H100_SXM, GPUSpec
from repro_torch.core.workload import Op, Workload

#: Fields every calibration entry must carry — the schema contract the
#: tuner writes and this module / the tests / the benchmark validate.
ENTRY_FIELDS = ("op", "arch", "shape", "kind", "source_op", "case",
                "flops", "bytes", "impls", "winner", "best_s")

#: Schema version the tuner stamps into ``calibration.json``. Bumped to
#: 2 when the quantized ops (quant_matmul / quant_decode_attention /
#: quant_paged_decode_attention) joined the tuning grids: a version-1
#: table silently lacks them, so :func:`load_calibration` rejects stale
#: payloads loudly instead of roofline-interpolating the quant ops from
#: unrelated entries.
CALIBRATION_VERSION = 2

#: calibration entry op name -> Workload IR op kind it measures
CALIB_OP_KIND = {
    "prefill_attention": "attention",
    "decode_attention": "attention",
    "paged_decode_attention": "attention",
    "quant_matmul": "matmul",
    "quant_decode_attention": "attention",
    "quant_paged_decode_attention": "attention",
    "ssd_scan": "scan",
    "moe_gemm": "matmul",
    "rmsnorm": "norm",
}

#: An op whose FLOPs are within this factor of a measured entry reuses
#: that entry's timing (linearly scaled) instead of the roofline rates.
MEASURED_MATCH_FACTOR = 4.0

GENERATE_HINT = (
    "no kernel calibration found at {path} — run the port's tuner first:\n"
    "    PYTHONPATH=src python -m repro_torch.kernels.tune --preset h100\n"
    "(on the card; --preset ci --device cpu checks the plumbing on a "
    "CPU host, where the timings mean nothing for the card. See README, "
    "the PyTorch/CUDA port.)")

#: How to regenerate a stale or empty calibration of ``preset``.
REGENERATE = ("    PYTHONPATH=src python -m repro_torch.kernels.tune "
              "--preset {preset}")


class CalibrationMissing(RuntimeError):
    """Raised instead of silently evaluating from an empty table."""


def load_calibration(path: Optional[str] = None) -> Dict[str, Any]:
    """Load + structurally validate a ``calibration.json`` payload."""
    path = path or calibration_path()
    if not os.path.exists(path):
        raise CalibrationMissing(GENERATE_HINT.format(path=path))
    with open(path) as f:
        payload = json.load(f)
    version = payload.get("version", 1)
    if version != CALIBRATION_VERSION:
        raise CalibrationMissing(
            f"calibration at {path} is schema version {version}, this "
            f"code expects {CALIBRATION_VERSION} (the quantized-op "
            f"grids) — stale table; regenerate:\n"
            + REGENERATE.format(preset=payload.get("preset", "h100")))
    entries = payload.get("entries")
    if not entries:
        raise CalibrationMissing(
            f"calibration at {path} has no entries — regenerate:\n"
            + REGENERATE.format(preset=payload.get("preset", "h100")))
    for i, e in enumerate(entries):
        missing = [k for k in ENTRY_FIELDS if k not in e]
        if missing:
            raise CalibrationMissing(
                f"calibration entry {i} at {path} is missing fields "
                f"{missing} — schema drift; regenerate with the current "
                f"tuner")
    return payload


class MeasuredModel:
    """``AcceleratorModel`` whose evaluate() reads measured timings.

    ``workload`` is anything :meth:`Workload.coerce` accepts (an
    ``lm_workload``, a hand-built op list); ``calibration`` is a loaded
    payload, a path, or None for the port's default artifact location;
    ``chip`` is the card whose peak the efficiency is taken against.

    ``evaluate`` accepts any :class:`DesignPoint` for protocol
    compatibility but ignores its knobs: measurements are facts about
    one configuration, not a function of design variables. The value of
    this model is as the *anchor* the analytical models are compared
    against (``repro_torch.bench.kernel_model_error``), as the paper uses
    board measurements.
    """

    name = "measured"

    def __init__(self, workload: Union[Workload, Any],
                 calibration: Union[None, str, Dict[str, Any]] = None,
                 chip: GPUSpec = H100_SXM):
        self.workload = Workload.coerce(workload)
        if isinstance(calibration, dict):
            self.calibration = calibration
        else:
            self.calibration = load_calibration(calibration)
        self.chip = chip
        self._by_kind: Dict[str, List[Dict[str, float]]] = {}
        for e in self.calibration["entries"]:
            kind = CALIB_OP_KIND.get(e["op"])
            if kind is None or e["best_s"] <= 0:
                continue
            self._by_kind.setdefault(kind, []).append({
                "op": e["op"], "arch": e["arch"],
                "flops": float(e["flops"]), "bytes": float(e["bytes"]),
                "best_s": float(e["best_s"]),
            })
        if not self._by_kind:
            raise CalibrationMissing(
                "calibration has no usable entries (all zero-time or "
                "unknown ops)")

    # -- rates ----------------------------------------------------------------
    def _entries_for(self, kind: str) -> List[Dict[str, float]]:
        if kind in self._by_kind:
            return self._by_kind[kind]
        # unmeasured kind (embed / router / conv / plain matmul on a
        # model with no MoE): fall back to every measured entry
        return [e for es in self._by_kind.values() for e in es]

    def achieved_rates(self, kind: str) -> Tuple[float, float]:
        """(FLOP/s, bytes/s) the measured kernels of ``kind`` achieved
        (medians across entries; the roofline-interpolation rates)."""
        es = self._entries_for(kind)
        flops_rates = [e["flops"] / e["best_s"] for e in es
                       if e["flops"] > 0]
        byte_rates = [e["bytes"] / e["best_s"] for e in es
                      if e["bytes"] > 0]
        F = statistics.median(flops_rates) if flops_rates else float("inf")
        B = statistics.median(byte_rates) if byte_rates else float("inf")
        return F, B

    # -- per-op latency -------------------------------------------------------
    def op_latency(self, op: Op) -> Tuple[float, str]:
        """Latency of one IR op: ``(seconds, 'measured'|'roofline')``.

        'measured': a calibration entry of the same kind sits within
        :data:`MEASURED_MATCH_FACTOR` in FLOPs — its timing is scaled
        linearly. 'roofline': no close entry; the kind's achieved rates
        bound the latency (max of compute and memory terms).
        """
        es = self._by_kind.get(op.kind, [])
        if op.flops > 0:
            close = [(abs(math.log(op.flops / e["flops"])), e)
                     for e in es if e["flops"] > 0]
            if close:
                dist, e = min(close, key=lambda t: t[0])
                if dist <= math.log(MEASURED_MATCH_FACTOR):
                    return e["best_s"] * op.flops / e["flops"], "measured"
        F, B = self.achieved_rates(op.kind)
        compute_s = op.flops / F if op.flops > 0 else 0.0
        memory_s = op.total_bytes / B if op.total_bytes > 0 else 0.0
        return max(compute_s, memory_s), "roofline"

    # -- the AcceleratorModel protocol ---------------------------------------
    def evaluate(self, point=None) -> EvalResult:
        per_op = []
        latency = 0.0
        n_measured = n_interp = 0
        for op in self.workload.ops:
            s, how = self.op_latency(op)
            latency += s
            n_measured += how == "measured"
            n_interp += how == "roofline"
            per_op.append({"name": op.name, "kind": op.kind,
                           "latency_s": s, "source": how})
        if latency <= 0:
            return EvalResult.infeasible(
                f"workload {self.workload.name!r} evaluated to zero "
                f"latency — empty or zero-cost ops", detail=per_op)
        model_flops = self.workload.model_flops()
        return EvalResult(
            gops=model_flops / latency / 1e9,
            throughput=1.0 / latency,
            latency_s=latency,
            efficiency=(model_flops / latency) / self.chip.peak_flops(),
            feasible=True,
            resources={"measured_ops": float(n_measured),
                       "interpolated_ops": float(n_interp)},
            detail=per_op)
