"""The MoE family on a mesh: CPU ranks over ``gloo``, smoke size, f32,
held to the JAX package's one-device functions (weights crossed through
numpy) and to the port's one device.

* serving (``ShardedServeEngine`` / ``ShardedPagedServeEngine``) of
  ``qwen2-moe-a2.7b`` (4 experts, top 2, one shared expert) at (1, 4)
  and (2, 2), expert-parallel; a copy with 6 experts at (1, 4), where
  the experts do not divide, ``sanitize_spec`` drops them
  (``indivisible``) and ``expert_ffn`` takes ``model`` (expert-split);
  ``mixtral-8x22b`` at (1, 2): every rank's tokens the JAX engine's,
  its bytes the sharded capacity model's;
* two train steps of qwen2-moe under IS at (2, 2) on the capacity path
  and on the dropless path: loss, ce, aux, gradient norm, step 0's
  gradients leaf by leaf and the parameters after the steps against the
  JAX package's jitted step. The batch overflows an expert's global
  capacity, so a rank that counted its own rows alone would drop other
  slots (shown here) and report another aux loss;
* the expert-split layer in bf16: the 6-expert copy's MoE FFN at
  (1, 4), the same input on every rank, held to one device's bf16
  output under a bar from bf16's unit roundoff and the partials summed;
* the placement's departures from the spec division, pinned: the router
  whole on every rank, the expert weights split as the sanitized spec
  says, at smoke size and at full width (qwen2-moe: 15 experts a rank at
  ``model`` 4, 176 columns of every expert at ``model`` 8).

Each mesh is one ``run_mesh`` spawn running every job on it in turn
(``torch_mesh_jobs.run_jobs``: the ranks import the port alone).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.serve import PagedServeEngine as JPaged  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train.loop import init_state as jinit_state  # noqa: E402
from repro.train.loop import make_train_step as jmake_step  # noqa: E402

from repro_torch.analysis.capacity import (capacity,  # noqa: E402
                                           serve_preflight)
from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.models import ModelRuntime, params_from_numpy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.train import AdamWConfig, TrainConfig  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

from torch_mesh_jobs import run_jobs  # noqa: E402

N_SLOTS, MAX_LEN, PAGE = 4, 64, 8
#: The train bars of tests/test_torch_train_mesh.py: losses 1e-5
#: relative, every leaf's gradient within 1e-4 of its largest.
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
B, S, STEPS = 4, 16, 2
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, schedule="wsd")
MESH_TIMEOUT = 240

#: (model id, arch, experts or None for the arch's own).
MODELS = (("qwen2-moe", "qwen2-moe-a2.7b", None),
          ("qwen2-moe-e6", "qwen2-moe-a2.7b", 6),
          ("mixtral", "mixtral-8x22b", None))
#: The serving cases of each mesh: (model id, paged).
SERVE = {(1, 4): (("qwen2-moe", False), ("qwen2-moe", True),
                  ("qwen2-moe-e6", False), ("qwen2-moe-e6", True)),
         (2, 2): (("qwen2-moe", False), ("qwen2-moe", True)),
         (1, 2): (("mixtral", False), ("mixtral", True))}
#: The train cases, at (2, 2) under IS: (case id, dropless).
TRAIN = (("capacity", False), ("dropless", True))
SERVE_IDS = [f"{m[0]}x{m[1]}-{n}-{'paged' if p else 'contiguous'}"
             for m, cases in SERVE.items() for n, p in cases]


def _with_experts(cfg, n):
    return cfg if n is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_experts=n))


@pytest.fixture(scope="module")
def models():
    """{model id: (port cfg, jax cfg, jax params as numpy, port params)}."""
    out = {}
    for name, arch, experts in MODELS:
        jcfg = _with_experts(jax_smoke(JAX_ARCHS[arch]), experts)
        cfg = _with_experts(smoke_config(ARCHS[arch]), experts)
        jp = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg))
        out[name] = (cfg, jcfg, jp, params_from_numpy(cfg, jp, device="cpu"))
    return out


def _prompts(vocab, paged):
    """tests/test_multidevice.py's prompts: short arithmetic ones, or a
    shared 16-token system prompt for the paged engine."""
    if not paged:
        return [(np.arange(3 + i) * 3 + i).astype(np.int32) % vocab
                for i in range(6)]
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, 16)
    return [np.concatenate([system, rng.integers(0, vocab, 3 + i)])
            .astype(np.int32) for i in range(6)]


def _requests(cfg, paged):
    return [dict(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_prompts(cfg.vocab_size, paged))]


def _engine_kw(paged):
    kw = dict(n_slots=N_SLOTS, max_len=MAX_LEN)
    if paged:
        kw["page_size"] = PAGE
    return kw


def _rt(dropless=False):
    return ModelRuntime(dtype="float32", remat="none", attn_chunk=8,
                        device="cpu", moe_dropless=dropless)


def _jrt(dropless=False):
    return JRuntime(dtype="float32", remat="none", attn_chunk=8,
                    moe_dropless=dropless)


def _batches(cfg):
    data = SyntheticLMData(S, B, cfg.vocab_size, seed=3)
    return [data.batch_at(i) for i in range(STEPS)]


def _tc():
    return TrainConfig(opt=AdamWConfig(**OPT))


@pytest.fixture(scope="module")
def jax_tokens(models):
    """{(model id, paged): the JAX engine's tokens of each request and
    its prefix-cache hits}."""
    out = {}
    for name, paged in {c for cases in SERVE.values() for c in cases}:
        cfg, jcfg, jp, _ = models[name]
        cls = JPaged if paged else JServe
        eng = cls(jax.tree.map(jnp.asarray, jp), jcfg, _jrt(),
                  **_engine_kw(paged))
        for r in _requests(cfg, paged):
            eng.submit(JRequest(**r))
        out[name, paged] = ({r.rid: [int(t) for t in r.out_tokens]
                             for r in eng.run()}, eng.stats.prefix_hits)
    return out


def _moe_layer(tp):
    """Layer 0's MoE weights, whole (f32)."""
    return {k: v[0] for k, v in tp["blocks"]["moe"].items()}


def _layer_x(cfg):
    """The MoE layer's input, the same on every rank (bf16, B 4 S 8)."""
    rng = np.random.default_rng(5)
    return torch.as_tensor(rng.standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)


@pytest.fixture(scope="module")
def meshes(models):
    """{mesh: every rank's job results}: one spawn a mesh; (2, 2) also
    takes the train steps."""
    out = {}
    for mesh, cases in SERVE.items():
        jobs = []
        for name, paged in cases:
            cfg, _, _, tp = models[name]
            jobs.append(("serve", (tp, cfg, [dict(
                rt=_rt(), requests=_requests(cfg, paged),
                engine_kw=_engine_kw(paged), paged=paged)])))
        if mesh == (1, 4):
            cfg, _, _, tp = models["qwen2-moe-e6"]
            jobs.append(("moe_layer", (_moe_layer(tp), cfg,
                                       _layer_x(cfg), torch.bfloat16)))
        if mesh == (2, 2):
            cfg, _, _, tp = models["qwen2-moe"]
            jobs.append(("train", ([dict(
                cfg=cfg, params=tp, rt=_rt(dropless), tc=_tc(),
                recipe="IS", batches=_batches(cfg), grads=True,
                gather=True) for _, dropless in TRAIN],)))
        out[mesh] = run_mesh(run_jobs, mesh, jobs, devices="cpu",
                             timeout=MESH_TIMEOUT)
    return out


@pytest.fixture(scope="module")
def reference(models):
    """{dropless: the JAX package's jitted one-device step on the
    global batches: per step its metrics, step 0's gradients, the
    parameters after the steps}."""
    cfg, jcfg, jp, _ = models["qwen2-moe"]
    out = {}
    for _, dropless in TRAIN:
        batches = [jax.tree.map(jnp.asarray, b) for b in _batches(cfg)]
        p = jax.tree.map(jnp.asarray, jp)
        grads = jax.jit(jax.grad(
            lambda p, b: jloss(p, jcfg, b, _jrt(dropless))[0]))(p,
                                                              batches[0])
        step = jax.jit(jmake_step(jcfg, _jrt(dropless),
                                  JTrain(opt=JAdamW(**OPT))))
        state, metrics = jinit_state(p), []
        for b in batches:
            state, mt = step(state, b)
            metrics.append({k: float(v) for k, v in mt.items()})
        out[dropless] = dict(metrics=metrics,
                             grads=jax.tree.map(np.asarray, grads),
                             params=jax.tree.map(np.asarray,
                                                 state["params"]))
    return out


def _serve_case(meshes, mesh, name, paged):
    i = SERVE[mesh].index((name, paged))
    return [r[i][0] for r in meshes[mesh]]


@pytest.mark.parametrize("mesh,name,paged", [
    (m, n, p) for m, cases in SERVE.items() for n, p in cases],
    ids=SERVE_IDS)
def test_sharded_engines_serve_the_jax_tokens(models, jax_tokens, meshes,
                                              mesh, name, paged):
    """Every rank serves the JAX engine's tokens, with its prefix-cache
    hits (mixtral's sliding window shares no prefix pages); each rank's
    parameter and cache bytes are the sharded capacity model's to the
    byte, and below one device's."""
    cfg = models[name][0]
    ranks = _serve_case(meshes, mesh, name, paged)
    assert len(ranks) == math.prod(mesh)
    assert {r["backend"] for r in ranks} == {"gloo"}
    tokens, hits = jax_tokens[name, paged]
    assert ranks[0]["tokens"] == tokens
    for r in ranks[1:]:
        assert r["tokens"] == ranks[0]["tokens"], r["rank"]
        assert r["stats"] == ranks[0]["stats"], r["rank"]
    assert ranks[0]["stats"]["prefix_hits"] == hits
    sizes = {"data": mesh[0], "model": mesh[1]}
    rep = serve_preflight(cfg, n_slots=N_SLOTS, max_len=MAX_LEN,
                          page_size=PAGE if paged else None, mesh=sizes,
                          dtype="float32", param_dtype="float32")
    one = serve_preflight(cfg, n_slots=N_SLOTS, max_len=MAX_LEN,
                          page_size=PAGE if paged else None,
                          dtype="float32", param_dtype="float32")
    for r in ranks:
        assert r["params_bytes"] == rep.params_bytes < one.params_bytes
        assert r["cache_bytes"] == rep.cache_bytes


#: bf16's unit roundoff.
BF16_U = 2.0 ** -8


def test_expert_split_moe_layer_in_bf16_is_held_to_one_device(models,
                                                              meshes):
    """The 6-expert copy at (1, 4) splits every expert's columns over
    ``model`` (8 of 32 a rank); with the same x on every rank the router,
    whole on each, routes alike, so the layer's output differs from one
    device's by rounding alone. Each rank's ``wo`` product leaves the
    grouped GEMM rounded to bf16 (at most u = 2^-8 of it, a product no
    larger than the output taken at one output's worth), the M partials
    are summed in f32, and one device rounds its product and its
    gate-weighted sum once each: the bar is (M + 2) u max|one device|.
    And the mesh is no further from the f32 layer than one device is,
    give or take one rounding (u max|one device|)."""
    cfg, _, _, tp = models["qwen2-moe-e6"]
    M = 4
    recs = [r[len(SERVE[(1, 4)])] for r in meshes[(1, 4)]]
    assert {r["split"] for r in recs} == {"ffn"}
    got = recs[0]["out"]
    for r in recs[1:]:
        assert torch.equal(r["out"], got)
    layer, x = _moe_layer(tp), _layer_x(cfg)

    def one(dtype):
        p = {k: v.to(torch.float32 if k in ("router", "shared_gate")
                      else dtype) for k, v in layer.items()}
        with torch.no_grad():
            return tmoe.moe_ffn(p, x.to(dtype), cfg, dropless=True)[0]

    ref, exact = one(torch.bfloat16), one(torch.float32)
    assert got.dtype == ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    dev = float((got - ref).abs().max())
    assert dev <= (M + 2) * BF16_U * scale, (dev, scale)
    assert float((got - exact).abs().max()) <= \
        float((ref - exact).abs().max()) + BF16_U * scale


@pytest.mark.parametrize("case,dropless", TRAIN, ids=[c[0] for c in TRAIN])
def test_mesh_train_step_matches_jax(meshes, reference, case, dropless):
    """Two IS steps at (2, 2) against the JAX package's two one-device
    steps: loss, ce, aux, gradient norm and learning rate per step,
    step 0's gradients per leaf, the parameters after the steps; every
    rank reports rank 0's scalars and holds its blocks of the state."""
    ranks = [r[-1][TRAIN.index((case, dropless))] for r in meshes[(2, 2)]]
    ref = reference[dropless]
    r0 = ranks[0]
    for i, jm in enumerate(ref["metrics"]):
        for k in ("loss", "aux"):
            assert abs(r0[k][i] - jm[k]) <= LOSS_RTOL * abs(jm["loss"]), k
        for k in ("ce", "grad_norm", "lr"):
            np.testing.assert_allclose(r0[k][i], jm[k], rtol=1e-5)
    want = dict(tree_items(ref["grads"]))
    for path, g in tree_items(r0["grads"]):
        d = float(np.max(np.abs(g.numpy() - want[path])))
        assert d <= GRAD_RTOL * float(np.max(np.abs(want[path]))), path
    lrs = sum(m["lr"] for m in ref["metrics"])
    want = dict(tree_items(ref["params"]))
    off = total = 0
    for path, got in tree_items(r0["state"]["params"]):
        d = np.abs(got.numpy() - want[path])
        assert d.max() <= 0.1 * lrs, (path, d.max())
        off, total = off + int((d > 1e-6).sum()), total + d.size
    assert off <= 1e-3 * total, (off, total)
    for r in ranks:
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert r[k] == r0[k], (r["rank"], k)
        assert r["blocks_equal"], r["rank"]
    rep = capacity(smoke_config(ARCHS["qwen2-moe-a2.7b"]),
                   ShapeConfig("train", S, B, "train"),
                   mesh={"data": 2, "model": 2}, recipe="IS")
    assert {r["state_bytes"] for r in ranks} == {rep.params_bytes * 3 + 4}


def test_mesh_aux_is_the_global_batchs(models, meshes):
    """The aux loss a mesh reports is the one-device aux of the global
    batch (the JAX package's, through ``loss_fn``), not the mean of the
    ranks' own: the capacity run's step-0 aux."""
    cfg, jcfg, jp, tp = models["qwen2-moe"]
    b = _batches(cfg)[0]
    _, m = jloss(jax.tree.map(jnp.asarray, jp), jcfg,
                 jax.tree.map(jnp.asarray, b), _jrt())
    rank0 = meshes[(2, 2)][0][-1][0]
    assert abs(rank0["aux"][0] - float(m["aux"])) <= 1e-5 * float(m["aux"])
    halves = []
    for d in range(2):
        rows = {k: v[d * B // 2:(d + 1) * B // 2] for k, v in b.items()}
        halves.append(float(jloss(jax.tree.map(jnp.asarray, jp), jcfg,
                                  jax.tree.map(jnp.asarray, rows),
                                  _jrt())[1]["aux"]))
    assert abs(np.mean(halves) - float(m["aux"])) > 1e-4


def test_batch_overflows_an_experts_global_capacity(models, monkeypatch):
    """The train batch makes an expert overflow its global capacity at
    the first MoE layer, and a data rank counting its own rows (its own
    capacity, its slots first) would keep other slots than one device
    keeps: the case that holds the mesh's capacity path to the global
    order."""
    cfg, _, _, tp = models["qwen2-moe"]
    m = cfg.moe
    seen = []
    route = tmoe._route

    def record(p, xt, cfg_, dpl=None):
        out = route(p, xt, cfg_, dpl)
        seen.append(out[1].clone())
        return out
    monkeypatch.setattr(tmoe, "_route", record)
    b = {k: torch.as_tensor(v) for k, v in _batches(cfg)[0].items()}
    with torch.no_grad():
        tmodel.forward(tp, cfg, b, _rt())
    idx = seen[0].reshape(-1)                   # (T * K,), token-major
    E, K, T = m.n_experts, m.experts_per_token, B * S

    def kept(e, cap):
        onehot = torch.nn.functional.one_hot(e, E)
        pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
        return pos < cap

    cap = math.ceil(K * T / E * m.capacity_factor)
    assert int(torch.bincount(idx, minlength=E).max()) > cap
    half = idx.numel() // 2
    local_cap = math.ceil(K * (T // 2) / E * m.capacity_factor)
    local = torch.cat([kept(idx[:half], local_cap),
                       kept(idx[half:], local_cap)])
    assert not torch.equal(local, kept(idx, cap))


@pytest.mark.parametrize("mesh,want", [
    ((1, 4), ("experts", 1, (1, 64, 32))),
    ((2, 2), ("experts", 2, (2, 32, 32))),
    ((1, 8), ("ffn", 4, (4, 64, 4)))])
def test_expert_parallel_placement_and_the_whole_router(mesh, want):
    """qwen2-moe smoke (4 experts): expert-parallel where the experts
    divide (each rank its ``n_experts`` from ``model`` coordinate x
    that), expert-split over ``model`` 8 (4 of the 32 columns a rank);
    the router whole on every rank in every case (the spec splits it
    over ``experts`` where they divide: a pinned departure)."""
    cfg = smoke_config(get_arch("qwen2-moe-a2.7b"))
    sizes = {"data": mesh[0], "model": mesh[1]}
    split, n, wi_block = want
    axes = dict(tree_items(tmodel.axes_tree(cfg)))
    defs = dict(tree_items(tmodel.param_defs(cfg)))
    for m in range(mesh[1]):
        pl = sh.Placement(cfg, sh.IS_RECIPE if mesh[0] > 1
                          else sh.DECODE_RECIPE, sizes,
                          coords={"data": 0, "model": m})
        assert (pl.moe_split, pl.n_experts) == (split, n)
        assert pl.expert_start == (m * n if split == "experts" else 0)
        wi = ("blocks", "moe", "wi")
        assert pl.local_shape(axes[wi], defs[wi].shape)[1:] == wi_block
        router = ("blocks", "moe", "router")
        assert pl.local_shape(axes[router], defs[router].shape) == \
            defs[router].shape
        spec = sh.sanitize_spec(pl.recipe.spec_for(axes[router]),
                                defs[router].shape, sizes)
        assert ("model" in spec) == (mesh[1] in (2, 4))


def test_expert_split_drops_the_experts_and_splits_their_columns():
    """Six experts over ``model`` 4 do not divide: ``sanitize_spec``
    records the ``indivisible`` drop on the experts dim and gives
    ``model`` to ``expert_ffn`` (32 columns, 8 a rank), and the placement
    runs every expert at its 8 columns."""
    cfg = _with_experts(smoke_config(get_arch("qwen2-moe-a2.7b")), 6)
    sizes = {"data": 1, "model": 4}
    axes = dict(tree_items(tmodel.axes_tree(cfg)))
    defs = dict(tree_items(tmodel.param_defs(cfg)))
    sh.reset_spec_drops()
    for leaf in ("wi", "wg", "wo"):
        key = ("blocks", "moe", leaf)
        spec = sh.sanitize_spec(sh.DECODE_RECIPE.spec_for(axes[key]),
                                defs[key].shape, sizes, path=leaf)
        assert spec.count("model") == 1
        assert spec.index("model") == axes[key].index("expert_ffn")
    drops = [d for d in sh.spec_drops() if d.path in ("wi", "wg", "wo")]
    assert {(d.path, d.reason, d.dim) for d in drops} == {
        (p, "indivisible", 6) for p in ("wi", "wg", "wo")}
    pl = sh.Placement(cfg, sh.DECODE_RECIPE, sizes, coords={"model": 1})
    assert (pl.moe_split, pl.n_experts, pl.expert_start) == ("ffn", 6, 0)
    assert pl.local_shape(axes[("blocks", "moe", "wo")],
                          defs[("blocks", "moe", "wo")].shape) == \
        (2, 6, 8, 64)


@pytest.mark.parametrize("arch,model,want", [
    ("qwen2-moe-a2.7b", 4, ("experts", 15, (15, 2048, 1408))),
    ("qwen2-moe-a2.7b", 8, ("ffn", 60, (60, 2048, 176))),
    ("mixtral-8x22b", 8, ("experts", 1, (1, 6144, 16384)))])
def test_full_width_expert_blocks(arch, model, want):
    """The per-rank expert shapes the grouped kernel runs at full width:
    qwen2-moe's 60 experts at 15 a rank over ``model`` 4, and at 1408 /
    8 = 176 columns of every expert over ``model`` 8 (60 does not
    divide); mixtral's 8 experts one a rank."""
    cfg = get_arch(arch)
    pl = sh.Placement(cfg, sh.DECODE_RECIPE, {"data": 1, "model": model})
    split, n, block = want
    assert (pl.moe_split, pl.n_experts) == (split, n)
    axes = dict(tree_items(tmodel.axes_tree(cfg)))
    defs = dict(tree_items(tmodel.param_defs(cfg)))
    key = ("blocks", "moe", "wi")
    assert pl.local_shape(axes[key], defs[key].shape)[1:] == block
