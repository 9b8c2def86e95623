"""The hot-path graph lint (``repro_torch.analysis.graph_lint``) on the
CPU: its rules on seeded steps (the reference's ``jaxpr_lint`` unit
cases and the port's own), its labels and (rule, severity) sets held to
the reference's ``lint_arch`` under the plain policy, and the ``ci``
preset under the card's policy: clean, with each label's kernel nodes
the launches its blocks make.
"""
import sys
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.jaxpr_lint import lint_arch as jlint_arch  # noqa: E402

from repro_torch.analysis import graph_lint as G  # noqa: E402
from repro_torch.analysis.registry import PRESETS, RULES  # noqa: E402
from repro_torch.analysis.runner import run_analysis  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.core.workload.torch_trace import \
    _abstract_params  # noqa: E402
from repro_torch.kernels.dispatch import TORCH_POLICY  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.scheduler import Scheduler  # noqa: E402

GRAPH_RULES = tuple(r for r in RULES if r.startswith("graph-"))
PARITY_ARCHS = ("minicpm-2b", "mamba2-1.3b", "zamba2-2.7b",
                "qwen2-moe-a2.7b")
MAX_LEN, PAGE, ATTN_CHUNK = 64, 8, 16


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def rule_ids(findings):
    return sorted({f.rule_id for f in findings})


def scan(fn, *args, rt_dtype="float32", pools=()):
    g, _, err = G.trace(fn, *args, pools=pools)
    assert err is None, err
    return G.scan_graph(g, label="t", rt_dtype=rt_dtype)


# ---------------------------------------------------------------------------
# The rules on seeded steps
# ---------------------------------------------------------------------------
def test_item_is_a_host_sync_named_by_its_frame():
    def step(x):
        n = x.sum().item()                         # the line named below
        return x * 2 + n

    line = step.__code__.co_firstlineno + 1
    found = scan(step, meta(4))
    assert rule_ids(found) == ["graph-host-sync"]
    assert f"test_torch_graph_lint.py:{line} (step)" in found[0].message
    assert "_local_scalar_dense" in found[0].message


def test_every_sync_is_reported_and_the_trace_goes_on():
    """A placeholder lets the trace continue past ``.item()``,
    ``nonzero``, a boolean-mask index and ``.tolist()``: each is one
    finding, the op after them still traced."""
    def step(x):
        bool(x[0] > 0)
        idx = torch.nonzero(x > 0)
        y = x[x > 0]
        x.tolist()
        return (idx.float().sum() + y.sum()) * 2

    g, out, err = G.trace(step, meta(6))
    assert err is None and out.device.type == "meta"
    found = G.scan_graph(g, label="t", rt_dtype="float32")
    assert rule_ids(found) == ["graph-host-sync"]
    whats = " ".join(f.message for f in found)
    for what in ("_local_scalar_dense", "nonzero", "boolean mask",
                 "copy to the host"):
        assert what in whats, what
    assert len(found) == 4
    assert g.nodes[-1][0] == "aten.mul.Tensor"


def test_a_sync_that_stops_the_trace_is_reported_once():
    """``repeat_interleave`` by a tensor of counts has no result on meta
    without ``output_size``: the trace stops there, and that sync alone
    is the finding (no trace failure beside it)."""
    def step(x, counts):
        return x.repeat_interleave(counts, dim=0) * 2

    g, _, err = G.trace(step, meta(4, 3), meta(4, dtype=torch.long))
    assert err is not None
    found = G._failed(g, err, "t", "the step")
    assert [f.rule_id for f in found] == ["graph-host-sync"]
    assert "the trace stops here" in found[0].message
    # with output_size it is no sync, and traces
    assert scan(lambda x, c: x.repeat_interleave(c, dim=0, output_size=8),
                meta(4, 3), meta(4, dtype=torch.long)) == []


def test_double_is_dtype_widen_only():
    found = scan(lambda x: x.double() * 2, meta(4))
    assert rule_ids(found) == ["graph-dtype-widen"]


def test_wide_dot_is_info_only():
    a, b = meta(4, 4, dtype=torch.bfloat16), meta(4, 4, dtype=torch.bfloat16)
    found = scan(lambda a, b: a.float() @ b.float(), a, b,
                 rt_dtype="bfloat16")
    assert rule_ids(found) == ["graph-wide-dot"]
    assert all(f.severity == "info" for f in found)
    # a bf16 product is not wide, nor is an f32 one under an f32 runtime
    assert scan(lambda a, b: a @ b, a, b, rt_dtype="bfloat16") == []
    assert scan(lambda a, b: a.float() @ b.float(), a, b) == []


def test_whole_int8_pool_upcast():
    """A whole int8 pool (the leaf, or one layer's) dequantized is an
    error; the gathered pages dequantized are not."""
    pool = meta(2, 9, 8, 2, 16, dtype=torch.int8)
    scales = meta(2, 9, 8, 2, dtype=torch.bfloat16)
    pools = [tuple(pool.shape), tuple(pool.shape[1:])]
    found = scan(lambda p, s: p[0].float() * s[0].float()[..., None],
                 pool, scales, pools=pools)
    assert rule_ids(found) == ["graph-int8-upcast"]
    found = scan(lambda p: p.to(torch.bfloat16), pool, pools=pools)
    assert rule_ids(found) == ["graph-int8-upcast"]
    table = torch.zeros((2, 4), dtype=torch.long, device="meta")
    assert scan(lambda p, t: p[0][t].float(), pool, table,
                pools=pools) == []


def _check(step, spec=None):
    spec = spec or {"k": ((2, 8, 4), torch.bfloat16),
                    "pos": ((2,), torch.int32)}
    tokens = torch.zeros((2,), dtype=torch.int32, device="meta")
    found, _ = G.check_step(step, lambda: G._meta_tree(spec), {}, tokens,
                            spec, label="t", rt_dtype=torch.bfloat16,
                            batch=2)
    return found


def _logits(c):
    return torch.zeros((2, 5), dtype=torch.bfloat16, device="meta")


def test_in_place_step_is_clean():
    def step(p, c, t):
        c["k"][:, 0] = 1
        c["pos"] += 1
        return c, _logits(c)

    assert _check(step) == []


def test_rebinding_a_cache_leaf_is_trace_unstable():
    def step(p, c, t):
        c = dict(c, k=c["k"] + 1)
        return c, _logits(c)

    found = _check(step)
    assert rule_ids(found) == ["graph-trace-unstable"]
    assert any(f.location.symbol == "t/k" for f in found)


def test_a_widened_cache_leaf_and_f32_logits_are_dtype_widen():
    def step(p, c, t):
        c = dict(c, k=c["k"].float())
        return c, _logits(c).float()

    found = _check(step)
    assert {(f.rule_id, f.location.symbol) for f in found} >= {
        ("graph-dtype-widen", "t/k"), ("graph-dtype-widen", "t"),
        ("graph-trace-unstable", "t/k")}


def test_a_trace_that_differs_between_calls_is_trace_unstable():
    calls = []

    def step(p, c, t):
        calls.append(1)
        if len(calls) % 2:
            c["k"].mul_(2)
        return c, _logits(c)

    found = _check(step)
    assert rule_ids(found) == ["graph-trace-unstable"]
    assert "different op sequence" in found[0].message


def test_a_step_that_fails_to_trace_is_trace_unstable():
    def step(p, c, t):
        raise ValueError("no")

    found = _check(step)
    assert rule_ids(found) == ["graph-trace-unstable"]


# ---------------------------------------------------------------------------
# Parity with the reference's lint_arch (the plain policy)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def parity():
    """{arch: (reference findings, port findings)} at max_len 64, page 8,
    the port under ``KernelPolicy.torch()``, as the reference runs its
    ``xla`` implementations."""
    return {a: (jlint_arch(a, max_len=MAX_LEN, page_size=PAGE),
                G.lint_arch(a, max_len=MAX_LEN, page_size=PAGE,
                            policy=TORCH_POLICY))
            for a in PARITY_ARCHS}


def _by_label(findings, prefix):
    out = {}
    for f in findings:
        rid = f.rule_id.replace("jaxpr-", "graph-") if prefix == "jaxpr" \
            else f.rule_id
        out.setdefault(f.location.symbol, set()).add((rid, f.severity))
    return out


def _labels(arch):
    cfg = smoke_config(get_arch(arch))
    out = {f"decode_step/{arch}"}
    if cfg.family != "ssm":
        out |= {f"decode_step_paged/{arch}",
                f"decode_step_paged/{arch}@int8"}
    return out | {f"prefill/{arch}@L{L}"
                  for L in Scheduler(cfg, MAX_LEN).prefill_lengths}


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_labels_and_rule_sets_match_the_reference(parity, arch):
    """Every label the reference traces, the port traces, and each has
    the reference's (rule, severity) set with ``jaxpr-`` -> ``graph-``:
    only ``graph-wide-dot`` info."""
    jfound, found = parity[arch]
    want = _by_label(jfound, "jaxpr")
    got = _by_label(found, "graph")
    assert set(want) == _labels(arch)
    assert got == want
    assert {r for v in got.values() for r in v} == {("graph-wide-dot",
                                                     "info")}


def _count(findings, label):
    (f,) = [f for f in findings if f.location.symbol == label]
    return int(f.message.split(" ")[0])


@pytest.mark.parametrize("arch", ("minicpm-2b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b"))
def test_wide_dot_counts_per_layer(parity, arch):
    """The reference counts its f32 dots once per scanned layer body (and
    once per scanned key chunk); the port unrolls its layers and its key
    chunks, so its counts are per step. Per layer and chunk, in the
    families of one block kind:

    * minicpm-2b: equal (the two f32 attention einsums);
    * qwen2-moe: the port has 2 more a layer. Its plain expert products
      (``moe_gemm_plain``) multiply in f32 as the Pallas body does, three
      f32 products where the reference's ``xla`` grouped GEMM gives bf16;
      and the reference forms the dropless slots' positions with a
      (T K) x (T K) f32 triangular product, the port with a cumsum;
    * mamba2: the port has fewer. JAX lowers every einsum to a
      ``dot_general``, the ones that contract nothing (``dt`` into the
      state, the ``B x`` outer product) included; torch takes those as
      broadcast products and keeps ``bmm`` for the contractions: 1 a
      decode layer where the reference has 3, and 2 a prefill layer at
      one chunk, 4 past it, where the reference has 6.
    """
    jfound, found = parity[arch]
    cfg = smoke_config(get_arch(arch))
    n = cfg.n_layers
    extra = {"minicpm-2b": 0, "qwen2-moe-a2.7b": 2}
    for L in Scheduler(cfg, MAX_LEN).prefill_lengths:
        label = f"prefill/{arch}@L{L}"
        ref, got = _count(jfound, label), _count(found, label)
        if arch == "mamba2-1.3b":
            assert (ref, got / n) == (6, 2 if L == 1 else 4), label
            continue
        chunks = -(-L // ATTN_CHUNK)
        # the attention einsums repeat per key chunk, the rest per layer
        assert got / n == ref + extra[arch] + 2 * (chunks - 1), label
    label = f"decode_step/{arch}"
    ref, got = _count(jfound, label), _count(found, label)
    if arch == "mamba2-1.3b":
        assert (ref, got / n) == (3, 1)
    else:
        assert got / n == ref + extra[arch]
        for lab in (f"decode_step_paged/{arch}",
                    f"decode_step_paged/{arch}@int8"):
            assert _count(found, lab) == got


# ---------------------------------------------------------------------------
# The ci preset under the card's policy
# ---------------------------------------------------------------------------
def test_ci_preset_is_clean_under_the_cuda_policy():
    """``python -m repro_torch.analysis --preset ci --strict`` runs the
    pass: no error and no warning (the SSM decode's f32 state products
    are its one info finding)."""
    report = run_analysis("ci", rules=list(GRAPH_RULES))
    assert "graph_lint" in report.passes
    assert report.counts()["error"] == report.counts()["warning"] == 0
    assert {(f.rule_id, f.location.symbol) for f in report.findings} == {
        ("graph-wide-dot", "decode_step/mamba2-1.3b")}
    assert report.exit_code(strict=True) == 0


def _expected_kernels(cfg, label):
    """The launches one step makes under the cuda policy, from the
    block schedule: two norms and attention (or the SSD scan, in
    prefill) a block, three grouped expert GEMMs an MoE layer, the final
    norm."""
    rt = M.ModelRuntime(dtype="bfloat16", device="meta")
    kinds = Counter(k for k, _, _ in M._schedule(_abstract_params(cfg, rt),
                                                 cfg))
    phase = label.split("/")[0]
    att = {"decode_step": "decode_attention",
           "decode_step_paged": "paged_decode_attention",
           "prefill": "flash_attention"}[phase]
    if label.endswith("@int8"):
        att = "quant_paged_decode_attention"
    want = Counter(rmsnorm=2 * (kinds["attn"] + kinds["mamba"]) + 1)
    if kinds["attn"]:
        want[att] = kinds["attn"]
    if kinds["mamba"] and phase == "prefill":
        want["ssd_scan"] = kinds["mamba"]
    if cfg.moe is not None:
        want["moe_gemm"] = 3 * kinds["attn"]
    return want


@pytest.mark.parametrize("arch", ("minicpm-2b", "mamba2-1.3b",
                                  "zamba2-2.7b", "qwen2-moe-a2.7b"))
def test_kernel_nodes_are_the_blocks_launches(arch):
    """Under the cuda policy each label's ``kernel:<op>`` nodes are the
    launches its blocks make (the ``ci`` archs and the two families the
    card's launch check also holds); no finding but wide-dot info."""
    p = PRESETS["ci"]
    cfg = smoke_config(get_arch(arch))
    kernels = {}
    found = G.lint_arch(arch, max_len=p.max_len, page_size=p.page_size,
                        kernels=kernels)
    assert {f.severity for f in found} <= {"info"}
    assert set(kernels) == _labels(arch)
    for label, got in kernels.items():
        assert got == _expected_kernels(cfg, label), label


def test_graph_lint_imports_neither_jax_nor_the_reference():
    import subprocess
    code = ("import sys, repro_torch.analysis.graph_lint; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
