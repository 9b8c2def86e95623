"""One-card analytic performance model: the reference's TPU-pod model at
one chip, on the card's numbers.

The port's counterpart of the reference's
``repro.core.analytical.tpu_model``: its equations with every shard
factor at 1 (``dp = model_axis = pods = 1``), priced with a
:class:`~repro_torch.core.hardware.GPUSpec`. For one (workload, plan) it
predicts the compute and HBM terms of a step and the step time, before
anything runs: the fast estimator inside the one-card DSE
(``repro_torch.core.dse.gpu_engine``) and the prediction ``chip_smoke.py``
holds against what the card measured. The reference's collective term
is identically 0 on one chip, so there is none here; the sharding
recipes (IS/WS dataflow, the front/tail split) change nothing on one
chip and are gone with it. The plan keeps the two knobs that still act:
the microbatch count and the remat policy.

Like the reference, this is a roofline: it charges the FLOPs the
workload's ops do against the bf16 peak and the bytes they move against
the HBM rate, with perfect overlap. What a run loses to launches, to
kernels below their roofline and to the work the profile leaves out
(norms' and activations' elementwise math, optimizer arithmetic) is the
distance the measurement shows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.analytical.interface import EvalResult
from repro_torch.core.hardware import H100_SXM, GPUSpec
from repro_torch.core.workload import Workload, dtype_bytes, lm_workload

#: Accuracy-proxy cost the DSE charges an int8 (weights + KV) candidate:
#: max abs logit deviation against bf16. This is the reference's value
#: (``repro.core.analytical.tpu_model``), the upper envelope its serving
#: parity harness measured across the smoke arch families; it only ranks
#: candidates on the accuracy axis, and is kept so that both DSEs rank
#: alike. Full-depth models on the card deviate more (PERF.md).
INT8_LOGIT_DEV_PROXY = 0.02


@dataclass(frozen=True)
class GPUPlan:
    """How one step runs on the card: gradient-accumulation microbatches
    and the remat policy (``none`` | ``full``)."""

    microbatches: int = 1
    remat: str = "full"


@dataclass
class GPUAnalysis:
    compute_s: float
    memory_s: float
    per_op: List[Dict] = field(default_factory=list)

    @property
    def step_s(self) -> float:
        """Perfect-overlap bound (the paper's max(...) form, Eq. 8/10)."""
        return max(self.compute_s, self.memory_s)

    @property
    def step_s_no_overlap(self) -> float:
        return self.compute_s + self.memory_s

    @property
    def dominant(self) -> str:
        return max(("compute_s", "memory_s"), key=lambda k: getattr(self, k))


def analyze(workload, shape_or_plan=None, plan: Optional[GPUPlan] = None,
            chip: GPUSpec = H100_SXM) -> GPUAnalysis:
    """Predict one step's compute and HBM terms on one card.

    ``analyze(workload, plan)`` prices any :class:`Workload`;
    ``analyze(cfg, shape, plan)`` builds the analytic LM profile first.
    """
    if isinstance(workload, ModelConfig):
        wl = lm_workload(workload, shape_or_plan)
    else:
        wl = Workload.coerce(workload)
        plan = shape_or_plan if plan is None else plan
    if not isinstance(plan, GPUPlan):
        raise TypeError(f"analyze needs a GPUPlan, got {type(plan).__name__}")
    M = max(1, plan.microbatches)
    is_train = wl.kind == "train"
    # fwd+bwd(+recompute) flop multiplier
    fmul = 1.0
    if is_train:
        fmul = 3.0 + (1.0 if plan.remat == "full" else 0.0)
    # weights are read from HBM once per use; a training step uses them
    # M x (fwd + recompute-if-remat + bwd) times
    uses = (M * (3.0 if plan.remat == "full" else 2.0)) if is_train else 1.0

    peak = chip.peak_flops("bfloat16")
    comp = mem = 0.0
    per_op = []
    for op in wl.ops:
        f = op.flops * fmul
        w_bytes = op.weight_bytes * uses
        if is_train:
            # f32 grads + Adam moments r/w
            w_bytes += 3 * 2 * op.weight_bytes
        a_bytes = op.act_in_bytes + op.act_out_bytes
        if is_train:
            a_bytes *= (3.0 if plan.remat == "none" else 4.0)
        comp += f / peak
        mem += (w_bytes + a_bytes) / chip.hbm_bw
        per_op.append({"name": op.name, "kind": op.kind,
                       "compute_s": f / peak,
                       "mem_s": (w_bytes + a_bytes) / chip.hbm_bw})
    return GPUAnalysis(comp, mem, per_op)


def hbm_footprint(cfg: ModelConfig, shape: ShapeConfig, plan: GPUPlan,
                  chip: GPUSpec = H100_SXM,
                  weight_dtype: Optional[str] = None,
                  kv_dtype: Optional[str] = None) -> Dict[str, float]:
    """HBM residency of one card (params/opt/grads/activation carries/KV),
    the feasibility gate the DSE enforces (the paper's M_max).

    ``weight_dtype``/``kv_dtype`` set the inference storage precision
    (default bfloat16). int8 KV adds the 2-byte bf16 scale per (token,
    kv-head) row. Training always counts f32 master params, Adam moments
    and grads.
    """
    n_params = cfg.param_count()
    wdt = weight_dtype or "bfloat16"
    kdt = kv_dtype or "bfloat16"
    out: Dict[str, float] = {}
    if shape.kind == "train":
        out["params_f32"] = 4.0 * n_params
        out["opt_f32"] = 8.0 * n_params
        out["grads_f32"] = 4.0 * n_params
        tokens_mb = shape.seq_len * shape.global_batch / plan.microbatches
        carry = tokens_mb * cfg.d_model * 2.0
        n_carry = cfg.n_layers if plan.remat != "none" else 4 * cfg.n_layers
        out["act_carries"] = carry * n_carry
    else:
        out["params"] = dtype_bytes(wdt) * n_params
        if cfg.family in ("dense", "moe", "vlm"):
            # decode against a cache longer than seq_len (ShapeConfig.kv_len)
            cache_len = shape.seq_len
            if shape.kind == "decode" and shape.kv_len:
                cache_len = shape.kv_len
            w = min(cfg.sliding_window or cache_len, cache_len)
            # bytes per cached element: payload + (int8 only) the bf16
            # per-row scale amortized over head_dim
            kv_elem = dtype_bytes(kdt) \
                + (2.0 if kdt == "int8" else 0.0) / max(cfg.head_dim, 1)
            out["kv_cache"] = (cfg.n_layers * shape.global_batch * w
                               * cfg.n_kv_heads * cfg.head_dim * 2 * kv_elem)
        if cfg.ssm is not None:
            s = cfg.ssm
            out["ssm_state"] = (cfg.n_layers * shape.global_batch
                                * s.n_heads(cfg.d_model) * s.head_dim
                                * s.d_state * 4)
    out["total"] = sum(out.values())
    out["fits"] = out["total"] <= chip.hbm_bytes
    return out


class GPUModel:
    """One card behind the shared ``AcceleratorModel`` protocol.

    Knobs: ``log2_m`` (gradient-accumulation microbatches, 2**0..2**6)
    and ``quant`` (>= 0.5: int8 weights + KV, priced on the int8 twin of
    the profile and charged :data:`INT8_LOGIT_DEV_PROXY`). Infeasible
    plans (indivisible or inference microbatching, int8 training, HBM
    overflow) come back as ``EvalResult.infeasible`` with the reason.
    """

    name = "h100"

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 chip: GPUSpec = H100_SXM,
                 workload: Optional[Workload] = None,
                 quant_workload: Optional[Workload] = None):
        self.cfg = cfg
        self.shape = shape
        # default: the analytic LM front-end; pass a traced workload
        # (trace_workload(cfg, shape)) to price the port's own op profile
        self.workload = workload if workload is not None \
            else lm_workload(cfg, shape)
        # the int8 twin of the same profile (halved weight/KV traffic,
        # identical flops) — evaluated when a point sets quant >= 0.5.
        # A traced workload without an explicit quant twin falls back to
        # the analytic int8 profile of the same (cfg, shape).
        self.quant_workload = quant_workload if quant_workload is not None \
            else lm_workload(cfg, shape, weight_dtype="int8",
                             kv_dtype="int8")
        self.chip = chip
        self._model_flops = self.workload.model_flops()

    def plan_for(self, point) -> GPUPlan:
        m = 2 ** int(min(max(point.get("log2_m", 0), 0), 6))
        return GPUPlan(microbatches=m, remat="full")

    def evaluate(self, point) -> EvalResult:
        plan = self.plan_for(point)
        if self.shape.kind == "train":
            gb = self.shape.global_batch
            if gb % plan.microbatches:
                return EvalResult.infeasible(
                    f"microbatches={plan.microbatches} indivisible for "
                    f"global_batch={gb}")
        elif plan.microbatches != 1:
            return EvalResult.infeasible(
                "microbatching only applies to training")
        quant = point.get("quant", 0) >= 0.5
        if quant and self.shape.kind == "train":
            return EvalResult.infeasible(
                "int8 storage precision is inference-only")
        wl = self.quant_workload if quant else self.workload
        foot = hbm_footprint(self.cfg, self.shape, plan, self.chip,
                             weight_dtype="int8" if quant else None,
                             kv_dtype="int8" if quant else None)
        if not foot["fits"]:
            return EvalResult.infeasible(
                f"HBM overflow: {foot['total'] / 1e9:.1f} GB "
                f"> {self.chip.hbm_bytes / 1e9:.1f} GB per chip",
                detail=foot)
        ana = analyze(wl, plan, chip=self.chip)
        if ana.step_s <= 0:
            return EvalResult.infeasible("degenerate step time",
                                         detail=ana)
        return EvalResult(
            gops=self._model_flops / ana.step_s / 1e9,
            throughput=1.0 / ana.step_s,          # steps/s
            latency_s=ana.step_s,
            # roofline fraction: useful FLOP/s over the card's peak
            efficiency=(self._model_flops / ana.step_s)
            / self.chip.peak_flops(),
            resources={"hbm_bytes": foot["total"],
                       "compute_s": ana.compute_s,
                       "memory_s": ana.memory_s,
                       "collective_s": 0.0,
                       "logit_dev": INT8_LOGIT_DEV_PROXY if quant
                       else 0.0},
            detail=ana)
