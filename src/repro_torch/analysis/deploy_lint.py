"""Deployment-feasibility lint of the port (counterpart of
``repro.analysis.deploy_lint``, on one card).

Static twin of a serving deployment. Given a model config, a traffic
:class:`~repro_torch.serve.scenarios.Scenario`, and a
:class:`DeploymentSpec` (slots, max_len, buckets, page budget, dtypes),
:func:`deploy_preflight` replays the *decisions* the serving stack
would make — ``Scheduler.plan``/``pages_for``, the paged engine's
submit gates, the prefill-shape inventory — and closes the loop with
M/G/1-style queueing bounds computed from the one-card analytic model's
per-token and per-prefill latencies
(``core.analytical.gpu_model.analyze`` on ``H100_SXM``, one microbatch,
no remat). No devices, no execution: every verdict is closed-form
shape/latency math, fast enough (<100 ms per (config, scenario) pair)
to run before the launcher allocates anything. On a mesh
(``DeploymentSpec.mesh``, ``deploy_preflight(mesh=)``) the bytes are
per device as the reference divides them (parameters over ``model``,
the cache over ``data`` x ``model``, the SSM state over ``data``), and
each latency bound is the one-card bound over the device count: no
placement moves less than its share of the bytes and operations, so
that stays a lower bound.

Rules
-----
``deploy-admission-deadlock`` (error)
    a request shape within ``max_len`` whose page demand exceeds the
    pool: head-of-line admission waits forever under the reject-less
    path.
``deploy-bucket-gap`` (warning / info)
    prompt lengths with no admissible plan, or chunk-mode forcing more
    than K of prompt tokens through one-token decode; ``buckets=()``
    (exact mode) downgrades to info.
``deploy-compile-unbounded`` (warning)
    whole-deployment prefill-shape inventory across buckets x admit
    widths x kv dtypes vs ``Scheduler.max_prefill_compiles``.
``deploy-slo-infeasible`` (error)
    rho >= 1 or a latency *lower bound* already exceeds the SLO at
    every admissible batch size — no simulator run can save the config.
``deploy-queue-saturation`` (warning)
    stable on average but the arrival process's peak rate drives the
    best operating point past the saturation knee (M/G/1 wait bound).
``deploy-capacity-overflow`` (error)
    static allocation (params + KV pool + SSM state, per device) or the
    scenario's concurrency demand exceeds each card's HBM.

All latency figures are *lower bounds* (service time only, zero
queueing, zero host overhead), so ``static p50 <= measured p50`` is a
soundness invariant: ``chip_smoke.py`` asserts it on the launcher's
scenario runs.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.capacity import mesh_sizes
from repro_torch.analysis.findings import Finding, Location
from repro_torch.analysis.prefill_compiles import predict_prefill_compiles
from repro_torch.analysis.registry import AnalysisContext, register_pass
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.analytical.gpu_model import GPUPlan, analyze
from repro_torch.core.hardware import H100_SXM, GPUSpec
from repro_torch.core.workload import dtype_bytes, lm_workload
from repro_torch.serve.scenarios import SCENARIOS, Scenario, get_scenario
from repro_torch.serve.scheduler import Scheduler

__all__ = ["DeploymentSpec", "DeployReport", "deploy_preflight",
           "default_deployment", "FIXTURE_ENV", "RULE_IDS"]

RULE_IDS = (
    "deploy-admission-deadlock",
    "deploy-bucket-gap",
    "deploy-compile-unbounded",
    "deploy-slo-infeasible",
    "deploy-queue-saturation",
    "deploy-capacity-overflow",
)

#: Env var naming a JSON file of extra ``{"cases": [...]}`` to lint —
#: the seeded-fixture hook the CLI tests drive findings through.
FIXTURE_ENV = "REPRO_TORCH_DEPLOY_SCENARIOS"


# ===========================================================================
# Deployment spec
# ===========================================================================
@dataclass(frozen=True)
class DeploymentSpec:
    """Everything the serving engine fixes before traffic arrives."""

    n_slots: int = 8
    max_len: int = 2048
    buckets: Optional[Tuple[int, ...]] = None   # None -> default; () -> exact
    admit_width: int = 1
    page_size: int = 16                          # 0 -> contiguous engine
    page_budget: Optional[int] = None            # pages incl. null page
    dtype: str = "bfloat16"                      # runtime compute dtype
    param_dtype: str = "bfloat16"
    kv_dtypes: Tuple[str, ...] = ()              # () -> (dtype,)
    mesh: Optional[Dict[str, int]] = None        # None -> one device
    hbm_gb: Optional[float] = None               # None -> chip HBM
    forced_decode_frac: float = 0.5              # bucket-gap threshold K
    saturation_rho: float = 0.85                 # queue-saturation knee

    def __post_init__(self):
        mesh_sizes(self.mesh)          # a dict of axis sizes, or None

    def kv_variants(self) -> Tuple[str, ...]:
        return tuple(self.kv_dtypes) or (self.dtype,)

    def to_json(self) -> dict:
        return {
            "n_slots": self.n_slots, "max_len": self.max_len,
            "buckets": None if self.buckets is None else list(self.buckets),
            "admit_width": self.admit_width,
            "page_size": self.page_size, "page_budget": self.page_budget,
            "dtype": self.dtype, "param_dtype": self.param_dtype,
            "kv_dtypes": list(self.kv_dtypes), "mesh": self.mesh,
            "hbm_gb": self.hbm_gb,
            "forced_decode_frac": self.forced_decode_frac,
            "saturation_rho": self.saturation_rho,
        }

    @classmethod
    def from_json(cls, data: dict) -> "DeploymentSpec":
        kw = dict(data)
        if kw.get("buckets") is not None:
            kw["buckets"] = tuple(int(b) for b in kw["buckets"])
        if kw.get("kv_dtypes"):
            kw["kv_dtypes"] = tuple(kw["kv_dtypes"])
        return cls(**kw)


def default_deployment(scenario: Scenario) -> DeploymentSpec:
    """Smallest power-of-two ``max_len`` that admits the scenario."""
    need = max(64, scenario.max_context())
    return DeploymentSpec(max_len=1 << (need - 1).bit_length()
                          if need & (need - 1) else need)


# ===========================================================================
# Closed-form latency model (the one-card roofline)
# ===========================================================================
#: One step as the engine runs it: one microbatch, nothing recomputed.
PLAN = GPUPlan(microbatches=1, remat="none")


def _decode_step_s(cfg: ModelConfig, batch: int, ctx: int, dep,
                   kv_dtype: str, plan: GPUPlan, chip: GPUSpec,
                   devices: int = 1) -> float:
    ctx = max(1, int(ctx))
    shape = ShapeConfig("deploy_decode", seq_len=ctx,
                        global_batch=max(1, int(batch)), kind="decode",
                        kv_len=ctx)
    wl = lm_workload(cfg, shape, weight_dtype=dep.param_dtype,
                     kv_dtype=kv_dtype)
    return analyze(wl, plan, chip=chip).step_s / devices


def _prefill_s(cfg: ModelConfig, length: int, width: int, dep,
               kv_dtype: str, plan: GPUPlan, chip: GPUSpec,
               devices: int = 1) -> float:
    shape = ShapeConfig("deploy_prefill", seq_len=max(1, int(length)),
                        global_batch=max(1, int(width)), kind="prefill")
    wl = lm_workload(cfg, shape, weight_dtype=dep.param_dtype,
                     kv_dtype=kv_dtype)
    return analyze(wl, plan, chip=chip).step_s / devices


def _page_count(tokens: int, page_size: int) -> int:
    return -(-int(tokens) // int(page_size))


def _pool_pages(cfg: ModelConfig, dep: DeploymentSpec, window: int,
                kv_dtype: str) -> int:
    """Pages in the pool incl. the null page — the PagedServeEngine's
    default budget derivation (equal-HBM re-denomination for quantized
    KV), in pure byte math."""
    if dep.page_budget is not None:
        return int(dep.page_budget)
    base = dep.n_slots * _page_count(window, dep.page_size)
    if kv_dtype != dep.dtype:
        per_tok_base = cfg.head_dim * int(dtype_bytes(dep.dtype))
        per_tok_kv = (cfg.head_dim * int(dtype_bytes(kv_dtype))
                      + (2 if kv_dtype == "int8" else 0))
        base = base * per_tok_base // per_tok_kv
    return base + 1


# ===========================================================================
# Report
# ===========================================================================
@dataclass
class DeployReport:
    """Structured result of one (config, scenario, deployment) lint."""

    arch: str
    scenario: str
    deployment: DeploymentSpec
    mesh: Dict[str, int]
    findings: List[Finding] = field(default_factory=list)
    rho: float = 0.0                 # utilization at the best batch
    rho_peak: float = 0.0            # same, at the arrival peak rate
    best_batch: int = 1
    service_s: float = 0.0           # E[service time] at best batch
    tok_p50_lb_ms: float = 0.0       # decode-step lower bound, mean ctx
    tok_p99_lb_ms: float = 0.0       # decode-step lower bound, p99 ctx
    ttft_lb_ms: float = 0.0          # prefill(+forced decode), p99 prompt
    concurrency_demand: float = 0.0  # Little's-law in-flight requests
    cache_tokens: int = 0            # KV tokens the config allocates
    alloc_bytes: float = 0.0         # params + cache + state, on the card
    hbm_bytes: float = 0.0
    compiles: int = 0                # prefill-shape inventory
    compile_bound: int = 0           # 0 = unbounded (exact mode)
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "scenario": self.scenario,
            "deployment": self.deployment.to_json(), "mesh": self.mesh,
            "findings": [f.to_json() for f in self.findings],
            "ok": self.ok, "rho": self.rho, "rho_peak": self.rho_peak,
            "best_batch": self.best_batch, "service_s": self.service_s,
            "tok_p50_lb_ms": self.tok_p50_lb_ms,
            "tok_p99_lb_ms": self.tok_p99_lb_ms,
            "ttft_lb_ms": self.ttft_lb_ms,
            "concurrency_demand": self.concurrency_demand,
            "cache_tokens": self.cache_tokens,
            "alloc_bytes": self.alloc_bytes, "hbm_bytes": self.hbm_bytes,
            "compiles": self.compiles, "compile_bound": self.compile_bound,
            "seconds": self.seconds,
        }


# ===========================================================================
# Rules
# ===========================================================================
def _rule_deadlock(cfg, sched, scen, dep, kv_dtype, loc) -> List[Finding]:
    """Replay the paged submit gate over the scenario's request shapes."""
    if dep.page_size <= 0 or not cfg.attention_layer_indices():
        return []
    pool = _pool_pages(cfg, dep, sched.window, kv_dtype)
    cap = pool - 1                     # page 0 is the reserved null page
    ps = dep.page_size
    for p in scen.prompt_lens.support:
        for o in scen.output_lens.support:
            if p + o > dep.max_len:
                continue               # overflow-rejected up front, no wedge
            need = sched.pages_for(p, o, ps)
            scatter = _page_count(min(sched.plan(p).prefill_len,
                                      sched.window), ps)
            if max(need, scatter) > cap:
                return [Finding(
                    rule_id="deploy-admission-deadlock", severity="error",
                    location=loc,
                    message=(
                        f"request shape (prompt={p}, new={o}) fits "
                        f"max_len={dep.max_len} but needs "
                        f"{max(need, scatter)} pages and the pool has "
                        f"{cap} usable (budget {pool} incl. null page, "
                        f"page_size={ps}, kv_dtype={kv_dtype}): the "
                        f"head-of-line admission wait can never be "
                        f"satisfied — the queue wedges permanently"),
                    suggestion=("raise --page-budget or shrink the "
                                "admissible shape (max_len / max_new); "
                                "overflow='truncate' only clips scatter, "
                                "not decode growth"))]
    return []


def _rule_bucket_gap(cfg, sched, scen, dep, loc) -> List[Finding]:
    out: List[Finding] = []
    o_min = scen.output_lens.min
    unserveable = [p for p in scen.prompt_lens.support
                   if p + o_min > dep.max_len]
    if not sched.prefill_lengths:      # buckets=() — exact mode
        # guard, not a crash: there is no bucket to cover any length
        out.append(Finding(
            rule_id="deploy-bucket-gap", severity="info", location=loc,
            message=(
                f"buckets=() (exact mode): no prefill bucket covers any "
                f"of the scenario's {len(scen.prompt_lens.support)} "
                f"prompt lengths (max {scen.prompt_lens.max}); every "
                f"distinct length traces its own prefill"),
            suggestion="use default_buckets(max_len) to bound compiles"))
        if unserveable:
            out.append(_unserveable_finding(unserveable, o_min, dep, loc))
        return out
    if unserveable:
        out.append(_unserveable_finding(unserveable, o_min, dep, loc))
    forced_mean = scen.prompt_lens.expect(
        lambda p: max(0, p - sched.plan(p).prefill_len))
    frac = forced_mean / max(1e-9, scen.prompt_lens.mean)
    if frac > dep.forced_decode_frac:
        out.append(Finding(
            rule_id="deploy-bucket-gap", severity="warning", location=loc,
            message=(
                f"chunk-mode admission forces {frac:.0%} of prompt "
                f"tokens through one-token decode steps (threshold "
                f"{dep.forced_decode_frac:.0%}) under buckets="
                f"{sched.prefill_lengths}: prefill throughput collapses "
                f"to decode throughput for this scenario"),
            suggestion=("add buckets near the scenario's prompt mass "
                        f"(support {scen.prompt_lens.support})")))
    return out


def _unserveable_finding(unserveable, o_min, dep, loc) -> Finding:
    return Finding(
        rule_id="deploy-bucket-gap", severity="warning", location=loc,
        message=(
            f"prompt lengths {tuple(unserveable)} in the scenario "
            f"support admit no plan: prompt + min output ({o_min}) "
            f"exceeds max_len={dep.max_len}, so every such request is "
            f"rejected or truncated"),
        suggestion="raise max_len or re-scope the scenario")


def _rule_compiles(cfg, sched, scen, dep, loc) -> Tuple[List[Finding],
                                                        int, int]:
    n_kv = len(dep.kv_variants())
    widths = (dep.admit_width,)
    inventory = predict_prefill_compiles(
        sched, scen.prompt_lens.support, widths) * n_kv
    bound = sched.max_prefill_compiles(len(widths)) * n_kv
    if bound == 0:                     # exact mode: no static bound
        if len(scen.prompt_lens.support) > 1:
            return ([Finding(
                rule_id="deploy-compile-unbounded", severity="warning",
                location=loc,
                message=(
                    f"exact-mode deployment (buckets=()) compiles one "
                    f"prefill per distinct prompt length x admit width "
                    f"x kv dtype: {inventory} for this scenario's "
                    f"support alone, unbounded across live traffic"),
                suggestion="set buckets to cap max_prefill_compiles")],
                inventory, bound)
        return [], inventory, bound
    if inventory > bound:
        return ([Finding(
            rule_id="deploy-compile-unbounded", severity="warning",
            location=loc,
            message=(
                f"whole-deployment compile inventory {inventory} "
                f"(buckets x {len(widths)} admit width(s) x {n_kv} kv "
                f"dtype(s)) exceeds the scheduler's declared bound "
                f"{bound}"),
            suggestion="widen buckets or drop kv-dtype variants")],
            inventory, bound)
    return [], inventory, bound


def _queue_rules(cfg, sched, scen, dep, kv_dtype, plan, chip,
                 loc, devices: int = 1) -> Tuple[List[Finding], dict]:
    """M/G/B stability + latency lower bounds over admissible batches."""
    window = sched.window
    slo = scen.slo
    rate = scen.arrival.rate_rps
    p_pts = tuple(zip(scen.prompt_lens.support, scen.prompt_lens.weights))
    o_pts = tuple(zip(scen.output_lens.support, scen.output_lens.weights))
    # prefill service per distinct prompt length (batch-independent:
    # every prefill call runs at the fixed admit width)
    pre: Dict[int, Tuple[float, int]] = {}
    for p, _ in p_pts:
        ap = sched.plan(p)
        pre[p] = (_prefill_s(cfg, ap.prefill_len, dep.admit_width, dep,
                             kv_dtype, plan, chip, devices),
                  max(0, p - ap.prefill_len))
    out_mean = scen.output_lens.mean
    ctx_mean = min(window, scen.prompt_lens.mean + out_mean / 2.0)
    p99_prompt = scen.prompt_lens.quantile(0.99)
    ctx_p99 = min(window, p99_prompt + scen.output_lens.quantile(0.99))

    best: Optional[dict] = None        # min-rho among latency-admissible
    closest: Optional[dict] = None     # best margin overall, for reporting
    for batch in range(1, max(1, dep.n_slots) + 1):
        t_dec = _decode_step_s(cfg, batch, ctx_mean, dep, kv_dtype,
                               plan, chip, devices)
        t_dec99 = _decode_step_s(cfg, batch, ctx_p99, dep, kv_dtype,
                                 plan, chip, devices)
        es = es2 = 0.0
        for p, wp in p_pts:
            t_pre, forced = pre[p]
            for o, wo in o_pts:
                s = t_pre + (forced + o) * t_dec
                es += wp * wo * s
                es2 += wp * wo * s * s
        rho = rate * es / batch
        ttft = pre[p99_prompt][0] + pre[p99_prompt][1] * t_dec
        cand = {"batch": batch, "rho": rho,
                "rho_peak": rate * scen.arrival.peak_factor * es / batch,
                "service_s": es, "service_s2": es2,
                "tok_p50_lb_ms": t_dec * 1e3,
                "tok_p99_lb_ms": t_dec99 * 1e3,
                "ttft_lb_ms": ttft * 1e3}
        lat_ok = (t_dec * 1e3 <= slo.tok_p50_ms
                  and t_dec99 * 1e3 <= slo.tok_p99_ms
                  and ttft * 1e3 <= slo.ttft_ms)
        if lat_ok and rho < 1.0 and (best is None or rho < best["rho"]):
            best = cand
        if closest is None or rho < closest["rho"]:
            closest = cand

    assert closest is not None
    if best is None:
        m = closest
        reason = (f"rho={m['rho']:.2f} at batch={m['batch']}"
                  if m["rho"] >= 1.0 else
                  f"latency lower bound over SLO at every batch "
                  f"(tok p50 {m['tok_p50_lb_ms']:.2f} ms vs "
                  f"{slo.tok_p50_ms:g}, p99 {m['tok_p99_lb_ms']:.2f} ms "
                  f"vs {slo.tok_p99_ms:g}, ttft {m['ttft_lb_ms']:.1f} ms "
                  f"vs {slo.ttft_ms:g})")
        return ([Finding(
            rule_id="deploy-slo-infeasible", severity="error",
            location=loc,
            message=(
                f"no batch in 1..{dep.n_slots} satisfies the scenario: "
                f"{reason} at rate {rate:g} req/s (kv_dtype={kv_dtype}) "
                f"— these are lower bounds, so no schedule or simulator "
                f"run can make this config meet its SLO"),
            suggestion=("quantize KV to cut the decode step, raise "
                        "n_slots, or relax the SLO"))],
            closest)
    findings: List[Finding] = []
    if best["rho_peak"] >= dep.saturation_rho:
        rp = best["rho_peak"]
        if rp < 1.0:
            wait_ms = (rate * scen.arrival.peak_factor * best["service_s2"]
                       / (2.0 * best["batch"] * (1.0 - rp))) * 1e3
            tail = f"M/G/1 wait bound ~{wait_ms:.0f} ms per request"
        else:
            tail = "the queue grows without bound for the burst duration"
        findings.append(Finding(
            rule_id="deploy-queue-saturation", severity="warning",
            location=loc,
            message=(
                f"stable on average (rho={best['rho']:.2f} at batch="
                f"{best['batch']}) but the {scen.arrival.process} peak "
                f"({scen.arrival.peak_rps:g} req/s) drives rho_peak="
                f"{rp:.2f} past the {dep.saturation_rho:g} knee: {tail}"),
            suggestion=("provision for the peak rate, not the mean — "
                        "more slots/devices or admission shedding")))
    return findings, best


def _rule_capacity(cfg, sched, scen, dep, kv_dtype, sizes, hbm_bytes,
                   metrics, loc) -> Tuple[List[Finding], int, float]:
    """Per-device bytes (the reference's division): static allocation
    and Little's-law demand."""
    dp = max(1, sizes.get("data", 1))
    ms = max(1, sizes.get("model", 1))
    window = sched.window
    n_attn = len(cfg.attention_layer_indices())
    params = dtype_bytes(dep.param_dtype) * cfg.param_count() / ms
    kv_elem = dtype_bytes(kv_dtype) \
        + (2.0 if kv_dtype == "int8" else 0.0) / max(cfg.head_dim, 1)
    kv_per_token = n_attn * cfg.n_kv_heads * cfg.head_dim * 2 * kv_elem
    if dep.page_size > 0 and n_attn:
        cache_tokens = _pool_pages(cfg, dep, window, kv_dtype) \
            * dep.page_size
    else:
        cache_tokens = dep.n_slots * window
    cache_bytes = cache_tokens * kv_per_token / (dp * ms)
    ssm_bytes = 0.0
    if cfg.ssm is not None:
        s = cfg.ssm
        ssm_bytes = (cfg.n_layers * dep.n_slots * s.n_heads(cfg.d_model)
                     * s.head_dim * s.d_state * 4) / dp
    alloc = params + cache_bytes + ssm_bytes
    demand = scen.arrival.rate_rps * metrics["service_s"]   # Little's law
    demand_tokens = min(demand, dep.n_slots) * min(
        window, scen.prompt_lens.mean + scen.output_lens.mean)
    findings: List[Finding] = []
    if alloc > hbm_bytes:
        findings.append(Finding(
            rule_id="deploy-capacity-overflow", severity="error",
            location=loc,
            message=(
                f"static allocation {alloc / 2**30:.3f} GiB per device "
                f"(params {params / 2**30:.3f} + cache "
                f"{cache_bytes / 2**30:.3f} + state "
                f"{ssm_bytes / 2**30:.3f}) exceeds the "
                f"{hbm_bytes / 2**30:.2f} GiB HBM budget at mesh "
                f"{dict(sizes)} (kv_dtype={kv_dtype})"),
            suggestion=("shrink n_slots/max_len/page budget, quantize "
                        "KV, or shard wider")))
    elif demand_tokens > cache_tokens:
        findings.append(Finding(
            rule_id="deploy-capacity-overflow", severity="error",
            location=loc,
            message=(
                f"scenario concurrency demand ({demand:.1f} in-flight "
                f"requests by Little's law, ~{demand_tokens:.0f} KV "
                f"tokens) exceeds the {cache_tokens} tokens the config "
                f"allocates: requests queue on cache space, not "
                f"compute"),
            suggestion="raise the page budget / n_slots or shed load"))
    return findings, int(cache_tokens), alloc


# ===========================================================================
# Entry point
# ===========================================================================
def deploy_preflight(cfg: ModelConfig, scenario, mesh=None, *,
                     deployment: Optional[DeploymentSpec] = None,
                     chip: Optional[GPUSpec] = None) -> DeployReport:
    """Statically lint one (config, scenario, deployment) point on one
    card or, with ``mesh`` (or ``DeploymentSpec.mesh``), on each device
    of a mesh of such cards (``chip``, default ``H100_SXM``).

    ``scenario`` is a :class:`Scenario` or a library name. Closed-form:
    nothing is allocated, so the launcher runs it before the model.
    """
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    dep = deployment or default_deployment(scenario)
    sizes = mesh_sizes(mesh if mesh is not None else dep.mesh)
    chip = chip or H100_SXM
    hbm_bytes = (dep.hbm_gb * 2**30 if dep.hbm_gb is not None
                 else chip.hbm_bytes)
    t0 = time.perf_counter()
    sched = Scheduler(cfg=cfg, max_len=dep.max_len, buckets=dep.buckets,
                      admit_width=dep.admit_width)
    plan = PLAN
    loc = Location(symbol=f"{cfg.name}/{scenario.name}")
    kv_primary = dep.kv_variants()[0]

    findings: List[Finding] = []
    findings.extend(_rule_bucket_gap(cfg, sched, scenario, dep, loc))
    cf, compiles, compile_bound = _rule_compiles(
        cfg, sched, scenario, dep, loc)
    findings.extend(cf)
    for kv in dep.kv_variants():
        findings.extend(_rule_deadlock(cfg, sched, scenario, dep, kv, loc))
    qf, metrics = _queue_rules(cfg, sched, scenario, dep, kv_primary,
                               plan, chip, loc,
                               math.prod(sizes.values()))
    findings.extend(qf)
    cache_tokens, alloc = 0, 0.0
    for kv in dep.kv_variants():
        kf, cache_tokens, alloc = _rule_capacity(
            cfg, sched, scenario, dep, kv, sizes, hbm_bytes, metrics, loc)
        findings.extend(kf)

    return DeployReport(
        arch=cfg.name, scenario=scenario.name, deployment=dep,
        mesh=dict(sizes), findings=findings,
        rho=metrics["rho"], rho_peak=metrics["rho_peak"],
        best_batch=metrics["batch"], service_s=metrics["service_s"],
        tok_p50_lb_ms=metrics["tok_p50_lb_ms"],
        tok_p99_lb_ms=metrics["tok_p99_lb_ms"],
        ttft_lb_ms=metrics["ttft_lb_ms"],
        concurrency_demand=scenario.arrival.rate_rps * metrics["service_s"],
        cache_tokens=cache_tokens, alloc_bytes=alloc, hbm_bytes=hbm_bytes,
        compiles=compiles, compile_bound=compile_bound,
        seconds=time.perf_counter() - t0)


# ===========================================================================
# Pass registration
# ===========================================================================
def _fixture_cases() -> List[DeployReport]:
    """Extra (arch, scenario, deployment) cases injected via env — the
    seeded-fixture path the CLI tests exercise rule ids through."""
    path = os.environ.get(FIXTURE_ENV)
    if not path:
        return []
    from repro_torch.configs import get_arch, smoke_config
    with open(path) as fh:
        spec = json.load(fh)
    reports = []
    for case in spec.get("cases", []):
        cfg = get_arch(case["arch"])
        if case.get("smoke", True):
            cfg = smoke_config(cfg)
        scen = case["scenario"]
        scen = (get_scenario(scen) if isinstance(scen, str)
                else Scenario.from_json(scen))
        dep = DeploymentSpec.from_json(case.get("deployment", {}))
        if case.get("scale", True):
            scen = scen.scaled(dep.max_len)
        reports.append(deploy_preflight(cfg, scen, deployment=dep))
    return reports


@register_pass(
    "deploy_lint",
    rules=RULE_IDS,
    description="deployment feasibility: scheduler-liveness replay + "
                "M/G/1 queueing bounds over the scenario library, on "
                "the one-card model")
def run_pass(ctx: AnalysisContext) -> List[Finding]:
    from repro_torch.configs import get_arch, smoke_config
    findings: List[Finding] = []
    dep = DeploymentSpec(n_slots=4, max_len=ctx.preset.max_len,
                         page_size=ctx.preset.page_size)
    for arch in ctx.preset.archs:
        cfg = get_arch(arch)
        if ctx.preset.smoke:
            cfg = smoke_config(cfg)
        for scen in SCENARIOS.values():
            rep = deploy_preflight(cfg, scen.scaled(dep.max_len),
                                   deployment=dep)
            findings.extend(rep.findings)
    for rep in _fixture_cases():
        findings.extend(rep.findings)
    return findings
