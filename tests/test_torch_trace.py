"""The port's trace front-end (``repro_torch.core.workload.torch_trace``)
against the reference's JAX trace, against itself on real tensors, and
feeding the one-card model, on the CPU.

Both front-ends trace the same cell of their own package's model: the
JAX one walks a jaxpr, the port's runs the call under a dispatch mode.
Every ``matmul`` (K, N) group must agree on FLOPs and weight bytes to
1e-9, and on its count once the two meanings of count are lined up: the
reference counts jaxpr equations (a ``lax.scan`` body once, its FLOPs
times the trip count), the port counts executed calls (a Python loop
over the layers). ``attention`` FLOPs must be equal where both run the
same dots; each place they do not is pinned to a formula in a test of
its own below, naming both lines of code.
"""
import dataclasses
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core.workload import trace_workload as jtrace  # noqa: E402

from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    diff_workloads,
    lm_workload,
    trace_workload,
)
from repro_torch.kernels.dispatch import (  # noqa: E402
    CUDA_POLICY,
    TORCH_POLICY,
    implementations,
    observe_kernels,
)
from repro_torch.models import (  # noqa: E402
    ModelRuntime,
    cast_params,
    forward,
    init_params,
)

REL = 1e-9
ARCHS = ("minicpm-2b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-2.7b")


def _cfgs(arch, **replace):
    """The smoke config of ``arch`` in both packages, with the same
    fields replaced (a sub-config field takes a dict of its fields)."""
    out = []
    for cfg in (jsmoke(jget_arch(arch)), smoke_config(get_arch(arch))):
        kw = {k: dataclasses.replace(getattr(cfg, k), **v)
              if isinstance(v, dict) else v for k, v in replace.items()}
        out.append(cfg.replace(**kw))
    return out


def _both(arch, kind, S, B, kv=None, **replace):
    jcfg, cfg = _cfgs(arch, **replace)
    ref = jtrace(jcfg, JShape("t", S, B, kind, kv_len=kv))
    got = trace_workload(cfg, ShapeConfig("t", S, B, kind, kv_len=kv))
    return cfg, ref, got


def _groups(wl, kind):
    """{(K, N): (count, flops, weight_bytes)} of one op kind."""
    out = {}
    for o in wl.ops:
        if o.kind == kind:
            m = re.match(r"\w+\.(\d+)x(\d+)(?:\(x(\d+)\))?$", o.name)
            out[int(m[1]), int(m[2])] = (int(m[3] or 1), o.flops,
                                         o.weight_bytes)
    return out


def _flops(wl, kind):
    return sum(o.flops for o in wl.ops if o.kind == kind)


def _close(a, b):
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def _trips(cfg, K, N):
    """How many times the port runs a group the reference's layer scan
    holds once: the layer count, the hybrid's shared-block groups once
    a group, the unembedding once."""
    if (K, N) == (cfg.d_model, cfg.vocab_size):
        return 1
    if cfg.family == "hybrid":
        di = cfg.ssm.d_inner(cfg.d_model)
        if K == di or N == 2 * di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state \
                + cfg.ssm.n_heads(cfg.d_model):
            return cfg.n_layers
        return cfg.n_layers // cfg.shared_attn_period
    return cfg.n_layers


def _assert_matmuls_agree(cfg, ref, got, expert_ratio=None):
    """Every matmul group: the same FLOPs, weight bytes and executed
    count. ``expert_ratio`` scales the reference's expert-GEMM FLOPs
    (the groups over an (E, K, N) weight) where the two run different
    row counts."""
    r, g = _groups(ref, "matmul"), _groups(got, "matmul")
    assert set(r) == set(g)
    experts = set()
    if cfg.moe is not None:
        m = cfg.moe
        experts = {(cfg.d_model, m.d_expert), (m.d_expert, cfg.d_model)}
    for key, (rc, rf, rw) in r.items():
        gc, gf, gw = g[key]
        assert gc == rc * _trips(cfg, *key), key
        assert _close(gw, rw), key
        if key in experts and expert_ratio is not None:
            continue                      # checked by the caller
        assert _close(gf, rf), key


# ===========================================================================
# The port's trace against the JAX trace
# ===========================================================================
@pytest.mark.parametrize("kind,kv", [("train", None), ("prefill", None),
                                     ("decode", 128)])
def test_dense_trace_matches_jax(kind, kv):
    cfg, ref, got = _both("minicpm-2b", kind, 64, 2, kv)
    _assert_matmuls_agree(cfg, ref, got)
    assert _close(_flops(got, "attention"), _flops(ref, "attention"))
    assert got.meta["kv_len"] == ref.meta["kv_len"]
    assert got.meta["pass"] == ref.meta["pass"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dense_embed_op_matches_jax(kind):
    """A table of 1 MiB (vocab 8192 x d 64 in bf16) is an ``embed`` op in
    both; the tied unembedding reads the same table as a matmul."""
    cfg, ref, got = _both("minicpm-2b", kind, 32, 2,
                          64 if kind == "decode" else None, vocab_size=8192)
    assert cfg.tie_embeddings
    (re_,), (ge,) = ([o for o in w.ops if o.kind == "embed"]
                     for w in (ref, got))
    assert (ge.name, ge.flops) == (re_.name, re_.flops) == \
        ("embed.0x64", 0.0)
    assert _close(ge.weight_bytes, re_.weight_bytes)
    assert ge.weight_bytes == 8192 * 64 * 2
    _assert_matmuls_agree(cfg, ref, got)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
@pytest.mark.parametrize("kind,kv", [("train", None), ("decode", 128)])
def test_ssm_and_hybrid_matmuls_match_jax(arch, kind, kv):
    # d_ff 96 keeps the hybrid's shared FFN groups apart from out_proj
    cfg, ref, got = _both(arch, kind, 64, 2, kv, d_ff=96)
    _assert_matmuls_agree(cfg, ref, got)


def test_moe_capacity_matmuls_match_jax():
    cfg, ref, got = _both("qwen2-moe-a2.7b", "train", 64, 2,
                          moe={"n_experts": 6, "d_expert": 48})
    _assert_matmuls_agree(cfg, ref, got)


# ---------------------------------------------------------------------------
# Where the two executables run different dots
# ---------------------------------------------------------------------------
def _capacity_dispatch_flops(T, K, E, C, d):
    """The reference's capacity path's activation dots (one layer):
    ``tril @ flat_choice`` for slot positions when ``T K <= 16384``, the
    (T, E, C) dispatch and combine einsums over k, the combine's gate
    scaling (a contraction-free dot), and the two (T, E, C) x d token
    moves."""
    tril = 2.0 * (T * K) ** 2 * E if T * K <= 16384 else 0.0
    return tril + 4.0 * K * T * E * C + 2.0 * T * K * C + 4.0 * T * E * C * d


def test_moe_capacity_dispatch_einsums_are_reference_only():
    """``repro/models/moe.py:166-192`` dispatches and combines with
    one-hot einsums (activation dots: ``attention`` in its trace);
    ``repro_torch/models/moe.py`` ``_routed_core`` gathers and index-adds
    the kept rows, which computes the same sums with no dot. The expert
    GEMMs at (E, C, d) and every other dot agree."""
    B, S = 2, 64
    cfg, ref, got = _both("qwen2-moe-a2.7b", "train", S, B,
                          moe={"n_experts": 6, "d_expert": 48})
    m = cfg.moe
    T, K, E = B * S, m.experts_per_token, m.n_experts
    C = max(K, min(math.ceil(K * T / E * m.capacity_factor), T))
    want = cfg.n_layers * _capacity_dispatch_flops(T, K, E, C, cfg.d_model)
    assert _close(_flops(ref, "attention") - _flops(got, "attention"), want)
    # the attention proper: the same dots in both
    heads = {k: v for k, v in _groups(ref, "attention").items()
             if cfg.head_dim in k}
    assert _close(sum(v[1] for v in heads.values()),
                  _flops(got, "attention"))


def test_dropless_decode_reference_runs_e_over_k_expert_flops():
    """Decode is dropless in both. Under ``xla`` the reference runs it as
    the capacity einsum with C = T (``repro/models/moe.py:76-88``): E T
    expert rows, plus the dispatch dots above. The port's dropless path
    (``repro_torch/models/moe.py`` ``_routed_grouped``) groups the K T
    routed rows: E / K times fewer expert FLOPs (15 at qwen2-moe's 60
    experts, top-4)."""
    B = 3
    cfg, ref, got = _both("qwen2-moe-a2.7b", "decode", 64, B, 128,
                          moe={"n_experts": 6, "d_expert": 48})
    _assert_matmuls_agree(cfg, ref, got, expert_ratio=True)
    m, d = cfg.moe, cfg.d_model
    E, K = m.n_experts, m.experts_per_token
    r, g = _groups(ref, "matmul"), _groups(got, "matmul")
    for key in ((d, m.d_expert), (m.d_expert, d)):
        assert _close(r[key][1], g[key][1] * E / K), key
        assert _close(g[key][1], cfg.n_layers * (2 if key[0] == d else 1)
                      * 2.0 * K * B * d * m.d_expert), key
    want = cfg.n_layers * _capacity_dispatch_flops(B, K, E, B, d)
    assert _close(_flops(ref, "attention") - _flops(got, "attention"), want)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
@pytest.mark.parametrize("B,S", [(2, 64), (3, 80)])
def test_ssd_third_operand_scaling_is_a_dot_in_jax_only(arch, B, S):
    """The SSD scan's two three-operand einsums (``repro/models/ssm.py
    :116`` and ``:133``; ``repro_torch/kernels/ssd_scan.py``
    ``ssd_chunked``) scale one operand by a third before contracting.
    ``jnp.einsum`` lowers that scaling to a contraction-free
    ``dot_general`` (K 1), which its trace counts; ``torch.einsum``
    multiplies elementwise. Per layer: 2 B Sp nh (hp + N), Sp the length
    padded to the chunk; every other dot is the same."""
    cfg, ref, got = _both(arch, "train", S, B, ssm={"d_state": 8})
    s = cfg.ssm
    nh, L = s.n_heads(cfg.d_model), s.chunk_size
    Sp = -(-S // L) * L
    want = cfg.n_layers * 2.0 * B * Sp * nh * (s.head_dim + s.d_state)
    assert _close(_flops(ref, "attention") - _flops(got, "attention"), want)
    k1 = sum(v[1] for k, v in _groups(ref, "attention").items()
             if k[0] == 1)
    assert _close(k1, want)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_decode_outer_product_is_a_dot_in_jax_only(arch):
    """The decode recurrence ``einsum("bhn,bhp,bh->bhpn")`` (``repro/
    models/ssm.py:210``; ``repro_torch/models/ssm.py``
    ``ssm_decode_step``): JAX lowers the dt scaling and the outer product
    to two K-1 dots, torch multiplies. Per layer 2 B nh N (1 + hp)."""
    B = 3
    cfg, ref, got = _both(arch, "decode", 64, B, 128, ssm={"d_state": 8})
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    want = cfg.n_layers * 2.0 * B * nh * s.d_state * (1 + s.head_dim)
    assert _close(_flops(ref, "attention") - _flops(got, "attention"), want)


# ===========================================================================
# The reference's own trace checks (tests/test_workload_ir.py), on the port
# ===========================================================================
@pytest.fixture(scope="module")
def tiny_dense():
    cfg = smoke_config(get_arch("minicpm-2b"))
    shape = ShapeConfig("tiny", 64, 2, "train")
    return cfg, shape, lm_workload(cfg, shape), trace_workload(cfg, shape)


def test_trace_matches_analytic_per_matmul_group(tiny_dense):
    """Traced FLOPs for a tiny dense config match the analytic front-end
    per matmul op (grouped by weight shape)."""
    cfg, shape, analytic, traced = tiny_dense
    a = {o.name: o for o in analytic.ops}
    t_mm = [o for o in traced.ops if o.kind == "matmul"]

    t_head = [o for o in t_mm if o.width == cfg.vocab_size]
    assert len(t_head) == 1
    assert t_head[0].flops == pytest.approx(a["lm_head"].flops)

    def k_dim(o):
        return int(re.match(r"\w+\.(\d+)x", o.name).group(1))

    t_ffn = sum(o.flops for o in t_mm
                if cfg.d_ff in (o.width, k_dim(o)))
    a_ffn = sum(o.flops for n, o in a.items() if n.endswith(".mlp"))
    assert t_ffn == pytest.approx(a_ffn)

    t_rest = sum(o.flops for o in t_mm) - t_head[0].flops - t_ffn
    a_rest = sum(o.flops for n, o in a.items()
                 if n.endswith(".qkv") or n.endswith(".attn_out"))
    assert t_rest == pytest.approx(a_rest)
    assert traced.weight_flops() == pytest.approx(analytic.weight_flops())


def test_trace_weight_bytes_match(tiny_dense):
    cfg, shape, analytic, traced = tiny_dense
    a_mm = sum(o.weight_bytes for o in analytic.ops if o.kind == "matmul")
    t_mm = sum(o.weight_bytes for o in traced.ops if o.kind == "matmul")
    assert t_mm == pytest.approx(a_mm)


def test_diff_workloads_report(tiny_dense):
    cfg, shape, analytic, traced = tiny_dense
    d = diff_workloads(analytic, traced)
    assert d["matmul_ratio"] == pytest.approx(1.0, abs=0.05)
    # causal-train analytic halves attention; the executable computes
    # the full (masked) score matrix -> ratio ~2 is the documented gap
    assert 1.0 <= d["activation_ratio"] <= 4.0
    assert d["while_loops"] == 0
    assert d["traced"] == "trace:minicpm-2b/tiny"


def test_trace_decode_and_ssm_families():
    # decode (KV cache consumption) on a tiny dense model, as the
    # reference's test traces it
    cfg = smoke_config(get_arch("chatglm3-6b"))
    wl = trace_workload(cfg, ShapeConfig("d", 64, 4, "decode", kv_len=128))
    assert wl.kind == "decode"
    assert wl.meta["kv_len"] == 128
    assert wl.weight_flops() > 0
    ssm = smoke_config(get_arch("mamba2-1.3b"))
    wl2 = trace_workload(ssm, ShapeConfig("t", 64, 2, "train"))
    assert wl2.weight_flops() > 0                   # in/out projections
    assert any(o.kind == "attention" for o in wl2.ops)


def test_trace_workload_meta_and_ops():
    cfg = smoke_config(get_arch("minicpm-2b"))
    wl = trace_workload(cfg, ShapeConfig("t", 64, 2, "prefill"))
    assert wl.frontend == "torch_trace" and wl.kind == "prefill"
    assert set(wl.meta) >= {"arch", "shape", "pass", "seq_len",
                            "global_batch", "kv_len", "param_bytes",
                            "trace_eqns", "trace_scans", "while_loops"}
    assert (wl.meta["trace_scans"], wl.meta["while_loops"]) == (0, 0)
    assert wl.meta["trace_eqns"] > 0
    assert all(o.layer_idx == -1 for o in wl.ops)
    assert wl.model_flops() == lm_workload(
        cfg, ShapeConfig("t", 64, 2, "prefill")).model_flops()
    n = sum(p.numel() * p.element_size()
            for p in _leaves(cast_params(init_params(cfg, 0, device="cpu"),
                                         ModelRuntime(device="cpu"))))
    assert wl.meta["param_bytes"] == n


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_tracer_counts_every_dot_and_gather_form():
    """The forms the port's models do not reach today: ``embedding`` and
    ``index_select`` of a table of 1 MiB or more, ``addmm``/``baddbmm``
    (a bias or an accumulator beside the product, a weight either side)
    and a convolution, on real tensors and on ``meta`` alike."""
    from repro_torch.core.workload.torch_trace import _Tracer

    for dev in ("cpu", "meta"):
        tr = _Tracer()
        table = torch.empty((4096, 128), device=dev)           # 2 MiB f32
        w = torch.empty((64, 32), device=dev)
        bias = torch.empty(32, device=dev)
        wb = torch.empty((3, 16, 8), device=dev)
        conv = torch.empty((6, 4, 3, 3), device=dev)
        for t in (table, w, bias, wb, conv):
            tr.mark(t)
        idx = torch.zeros(10, dtype=torch.long, device=dev)
        x = torch.empty((5, 64), device=dev)
        with tr:
            torch.nn.functional.embedding(idx, table)
            torch.index_select(table, 0, idx)
            torch.addmm(bias, x, w)
            torch.baddbmm(torch.empty((3, 7, 8), device=dev),
                          torch.empty((3, 7, 16), device=dev), wb)
            torch.baddbmm(torch.empty((3, 16, 5), device=dev),
                          wb.transpose(1, 2).transpose(1, 2),
                          torch.empty((3, 8, 5), device=dev))
            torch.nn.functional.conv2d(torch.empty((2, 4, 9, 9), device=dev),
                                       conv)
        got = [(r["kind"], r["K"], r["N"], r["flops"], r["weight_bytes"])
               for r in tr.st.records]
        assert got == [
            ("embed", 0, 128, 0.0, 4096 * 128 * 4),
            ("embed", 0, 128, 0.0, 4096 * 128 * 4),
            ("matmul", 64, 32, 2.0 * 64 * 5 * 32, 64 * 32 * 4),
            ("matmul", 16, 8, 2.0 * 16 * 3 * 7 * 8, 3 * 16 * 8 * 4),
            ("matmul", 8, 16, 2.0 * 8 * 3 * 16 * 5, 3 * 16 * 8 * 4),
            ("conv", 36, 6, 2.0 * 36 * 2 * 6 * 7 * 7, 6 * 4 * 3 * 3 * 4),
        ], dev


# ===========================================================================
# Abstract against real tensors
# ===========================================================================
def _key(wl):
    return [(o.kind, o.name, o.flops, o.weight_bytes, o.act_in_bytes,
             o.act_out_bytes) for o in wl.ops]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,kv,dropless", [
    ("train", None, False), ("prefill", None, True), ("decode", 96, False)])
def test_abstract_trace_equals_real_trace(arch, kind, kv, dropless):
    """The ``meta`` trace equals the trace of the same call on real CPU
    tensors, op for op, under the ``torch`` policy and under ``cuda``
    (whose wrappers run their plain versions on CPU tensors): kernel
    calls are counted as their plain versions compute them, whatever
    runs. Decode is dropless for the MoE model, as served."""
    cfg = smoke_config(get_arch(arch))
    shape = ShapeConfig("s", 64, 2, kind, kv_len=kv)
    rt = ModelRuntime(remat="none", attn_chunk=32, kernels=TORCH_POLICY,
                      device="cpu", moe_dropless=dropless)
    abstract = trace_workload(cfg, shape, rt=rt)
    params = cast_params(init_params(cfg, 0, device="cpu"), rt)
    for pol in (TORCH_POLICY, CUDA_POLICY):
        real = trace_workload(cfg, shape, params=params,
                              rt=dataclasses.replace(rt, kernels=pol))
        assert _key(real) == _key(abstract), pol.describe()


def test_int8_kv_decode_traces_abstract_and_real():
    cfg = smoke_config(get_arch("zamba2-2.7b"))
    rt = ModelRuntime(remat="none", kernels=TORCH_POLICY, device="cpu",
                      kv_dtype="int8")
    shape = ShapeConfig("d", 64, 3, "decode", kv_len=100)
    abstract = trace_workload(cfg, shape, rt=rt)
    real = trace_workload(cfg, shape, rt=rt, params=cast_params(
        init_params(cfg, 0, device="cpu"), rt))
    assert _key(real) == _key(abstract)
    assert _groups(abstract, "attention")[cfg.head_dim, 100][0] == \
        cfg.n_layers // cfg.shared_attn_period


def test_tracing_changes_neither_the_result_nor_the_policy(monkeypatch):
    """Under the tracer the policy's implementation still runs on the
    caller's arguments, and the logits are bit for bit the untraced
    ones."""
    cfg = smoke_config(get_arch("qwen2-moe-a2.7b"))
    rt = ModelRuntime(remat="none", kernels=CUDA_POLICY, device="cpu",
                      moe_dropless=True)
    params = cast_params(init_params(cfg, 0, device="cpu"), rt)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
        .astype(np.int32))
    calls = []
    table = implementations("rmsnorm")
    cuda_impl = table["cuda"]

    def recording(*a, **kw):
        calls.append(a[0].device.type)
        return cuda_impl(*a, **kw)

    monkeypatch.setitem(table, "cuda", recording)
    with torch.no_grad():
        want = forward(params, cfg, {"tokens": tokens}, rt)[0]
        n = len(calls)
        seen = []

        def observer(op, run, arrays, kwargs):
            seen.append(op)
            return run()

        with observe_kernels(observer):
            got = forward(params, cfg, {"tokens": tokens}, rt)[0]
    assert torch.equal(got, want)
    assert len(calls) == 2 * n and set(calls) == {"cpu"}
    assert "moe_gemm_glu" in seen and "moe_gemm" not in seen
    assert seen.count("rmsnorm") == n
    wl = trace_workload(cfg, ShapeConfig("s", 16, 2, "prefill"),
                        params=params, rt=rt)
    assert len(calls) == 3 * n
    assert wl.weight_flops() > 0


@pytest.mark.cuda
def test_card_trace_equals_abstract_trace():
    """On the card the ``cuda`` policy launches the kernels (invisible to
    the dispatch mode) and the trace still equals the abstract one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA unavailable on this host)")
    from repro_torch.kernels.rmsnorm import rmsnorm
    cfg = smoke_config(get_arch("minicpm-2b"))
    rt = ModelRuntime(remat="none", attn_chunk=64)
    shape = ShapeConfig("s", 64, 2, "prefill")
    params = cast_params(init_params(cfg, 0, device="cuda"), rt)
    rmsnorm.launches = 0
    card = trace_workload(cfg, shape, params=params, rt=rt)
    assert rmsnorm.launches > 0
    abstract = trace_workload(
        cfg, shape, rt=dataclasses.replace(rt, kernels=TORCH_POLICY))
    assert _key(card) == _key(abstract)


# ===========================================================================
# Full-width registry shapes, abstract
# ===========================================================================
class _NoAllocation(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the largest tensor any op makes off the ``meta`` device."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in torch.utils._pytree.tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor) and o.device.type != "meta":
                self.largest = max(self.largest,
                                   o.numel() * o.element_size())
        return out


@pytest.mark.parametrize("spec", ["minicpm-2b/train_4k",
                                  "qwen2-moe-a2.7b/prefill_32k",
                                  "mamba2-1.3b/decode_32k",
                                  "zamba2-2.7b/prefill_32k"])
def test_full_width_traces_allocate_nothing(spec):
    arch, shape = spec.split("/")
    guard = _NoAllocation()
    with guard:
        wl = trace_workload(arch, shape)
    assert guard.largest == 0
    cfg = get_arch(arch)
    assert wl.meta["param_bytes"] > 1e9
    d = diff_workloads(lm_workload(arch, shape), wl)
    assert d["weight_bytes_ratio"] == pytest.approx(1.0, abs=0.01)
    if arch == "minicpm-2b":
        assert abs(d["matmul_ratio"] - 1.0) <= 0.05
        assert any(o.kind == "embed" and o.width == cfg.d_model
                   for o in wl.ops)


# ===========================================================================
# The one-card model and its DSE on a traced workload
# ===========================================================================
def test_traced_workload_drives_gpu_model_and_explore_gpu():
    from repro_torch.configs import get_shape
    from repro_torch.core.analytical import DesignPoint, GPUModel
    from repro_torch.core.dse import explore_gpu

    cfg, shape = get_arch("minicpm-2b"), get_shape("train_4k")
    traced = trace_workload(cfg, shape)
    model = GPUModel(cfg, shape, workload=traced)
    assert model.workload is traced
    # no quant twin given: the analytic int8 profile, as the reference
    assert model.quant_workload.name == lm_workload(
        cfg, shape, weight_dtype="int8", kv_dtype="int8").name
    r = model.evaluate(DesignPoint.make(log2_m=3, quant=0))
    assert r.feasible and r.latency_s > 0
    base = GPUModel(cfg, shape).evaluate(DesignPoint.make(log2_m=3, quant=0))
    # the traced profile holds the full causal score matrix: more work
    assert r.latency_s >= base.latency_s
    res = explore_gpu(cfg, shape, workload=traced, n_particles=6, n_iters=4)
    assert res.best_fitness > 0
    assert res.best_analysis.step_s > 0
