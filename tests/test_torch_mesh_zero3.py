"""Serving with the weights split over ``data`` (``IS``, ``*+zero3``) on
CPU ranks over ``gloo``, at ``smoke_config`` in f32, every decoder
family: dense (``minicpm-2b``: contiguous, paged with the prefix cache
on, int8 KV), the VLM, the MoE expert-parallel (4 experts) and
expert-split (a copy with 5, which do not divide ``model`` 2), the SSM
under ``WS_seq+zero3`` and the hybrid, each at meshes (2, 2) and (2, 1).

Each case holds three things:

* its logits, teacher-forced (a prompt that outruns the scheduler's
  largest bucket has its tail forced through decode steps) and greedy,
  equal bit for bit to the same mesh's under the recipe without the
  ``data`` split (a gather is a concatenation);
* its tokens equal to the port's one-device engine's and the JAX
  package's on the same weights;
* each rank's parameter and cache bytes equal to ``capacity(mesh=...,
  recipe=...)``'s, the parameters about half the base recipe's.

Besides: the JAX package's own ``ShardedServeEngine`` under ``IS`` at
(2, 2) (a subprocess with forced host devices) serves the port's
tokens; ``mesh_forward`` under ``WS+zero3`` gives ``WS``'s logits for
hubert-xlarge and minicpm-2b; and a gather that reorders or drops a
``data`` block breaks the bit equality. Each mesh is one ``run_mesh``
spawn serving every case.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.serve import PagedServeEngine as JPaged  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402

from repro_torch.analysis.capacity import (capacity,  # noqa: E402
                                           default_page_budget)
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.dist.sharding import (RECIPES, get_recipe,  # noqa: E402
                                       shard_tree)
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.models import ModelRuntime, params_from_numpy  # noqa: E402
from repro_torch.models.model import axes_tree  # noqa: E402
from repro_torch.serve import (PagedServeEngine, Request,  # noqa: E402
                               Scheduler, ServeEngine)
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_mesh_jobs import run_jobs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLOTS, MAX_LEN, PAGE = 4, 64, 8
#: The prefill buckets: every contiguous prompt (9-14 tokens) is
#: prefilled at 8 and its tail forced through decode steps; a paged
#: prompt (16 shared + 3-13) is padded to 24 and hits the shared prefix
#: pages, or outruns 24 and has its tail forced (chunk mode caches no
#: prefix).
BUCKETS, PAGED_BUCKETS = (8,), (16, 24)
NEW = 4
MESH_TIMEOUT = 240
#: tests/test_torch_kernels.py's f32 bar of a forward's logits.
F32_TOL = dict(atol=5e-5, rtol=1e-5)

#: {model id: (arch, experts or None for the arch's own)}.
MODELS = {"minicpm": ("minicpm-2b", None), "vlm": ("qwen2-vl-7b", None),
          "moe": ("qwen2-moe-a2.7b", None), "moe-e5": ("qwen2-moe-a2.7b", 5),
          "mamba2": ("mamba2-1.3b", None), "zamba2": ("zamba2-2.7b", None),
          "hubert": ("hubert-xlarge", None)}
#: (case id, model id, paged, kv dtype, recipe, its base without the
#: data split).
CASES = (("dense", "minicpm", False, None, "IS", "WS"),
         ("dense-paged", "minicpm", True, None, "decode+zero3", "decode"),
         ("dense-int8", "minicpm", False, "int8", "WS+zero3", "WS"),
         ("vlm", "vlm", False, None, "decode+zero3", "decode"),
         ("moe-expert-parallel", "moe", False, None, "decode+zero3",
          "decode"),
         ("moe-expert-split", "moe-e5", False, None, "IS", "WS"),
         ("ssm", "mamba2", False, None, "WS_seq+zero3", "WS_seq"),
         ("hybrid", "zamba2", True, None, "IS", "WS"))
MESHES = ((2, 2), (2, 1))
#: The decoders whose forward runs under WS+zero3 beside WS at (2, 2).
FORWARD = ("hubert", "minicpm")
#: The broken gathers, served on (2, 1) in the dense case.
BROKEN = ("reorder", "drop")
IDS = [f"{m[0]}x{m[1]}-{c[0]}" for m in MESHES for c in CASES]
PARAMS = [(m, c) for m in MESHES for c in CASES]


def _with_experts(cfg, n):
    return cfg if n is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_experts=n))


@pytest.fixture(scope="module")
def models():
    """{model id: (port cfg, jax cfg, jax params as numpy, port params)}."""
    out = {}
    for name, (arch, experts) in MODELS.items():
        jcfg = _with_experts(jax_smoke(JAX_ARCHS[arch]), experts)
        cfg = _with_experts(smoke_config(ARCHS[arch]), experts)
        jp = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg))
        out[name] = (cfg, jcfg, jp, params_from_numpy(cfg, jp, device="cpu"))
    return out


def _prompts(vocab, paged):
    """Six prompts: 9-14 arithmetic tokens, or a shared 16-token system
    prompt and 3, 5, .., 13 more for the paged engine."""
    if not paged:
        return [(np.arange(9 + i) * 3 + i).astype(np.int32) % vocab
                for i in range(6)]
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, 16)
    return [np.concatenate([system, rng.integers(0, vocab, 3 + 2 * i)])
            .astype(np.int32) for i in range(6)]


def _requests(cfg, paged):
    return [dict(rid=i, prompt=p, max_new_tokens=NEW)
            for i, p in enumerate(_prompts(cfg.vocab_size, paged))]


def _engine_kw(cfg, paged, scheduler=Scheduler):
    kw = dict(n_slots=N_SLOTS, max_len=MAX_LEN, scheduler=scheduler(
        cfg=cfg, max_len=MAX_LEN,
        buckets=PAGED_BUCKETS if paged else BUCKETS))
    if paged:
        kw["page_size"] = PAGE
    return kw


def _rt(kv=None):
    return ModelRuntime(dtype="float32", remat="none", attn_chunk=8,
                        device="cpu", kv_dtype=kv)


def _run(cfg, paged, kv):
    return dict(rt=_rt(kv), requests=_requests(cfg, paged),
                engine_kw=_engine_kw(cfg, paged), paged=paged)


def _frames(cfg):
    rng = np.random.default_rng(3)
    if cfg.family == "audio":
        return {"embeds": rng.standard_normal(
            (4, 12, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (4, 12))
            .astype(np.int32)}


@pytest.fixture(scope="module")
def meshes(models):
    """{mesh: rank 0's results and every rank's}: one spawn a mesh, each
    case under its recipe and its base; (2, 2) also runs the forwards,
    (2, 1) the broken gathers."""
    out = {}
    for mesh in MESHES:
        jobs = []
        for _, name, paged, kv, recipe, base in CASES:
            cfg, _, _, tp = models[name]
            for r in (recipe, base):
                jobs.append(("logits", (tp, cfg, [_run(cfg, paged, kv)], r)))
        if mesh == (2, 2):
            for name in FORWARD:
                cfg, _, _, tp = models[name]
                runs = [dict(rt=_rt(), batch=_frames(cfg))]
                jobs += [("forward", (tp, cfg, runs, r))
                         for r in ("WS+zero3", "WS")]
        else:
            cfg, _, _, tp = models["minicpm"]
            jobs += [("logits", (tp, cfg, [_run(cfg, False, None)], "IS",
                                 how)) for how in BROKEN]
        out[mesh] = run_mesh(run_jobs, mesh, jobs, devices="cpu",
                             timeout=MESH_TIMEOUT)
    return out


def _case(meshes, mesh, case):
    """(the case's records on every rank, its base's on every rank)."""
    i = CASES.index(case)
    ranks = meshes[mesh]
    return ([r[2 * i][0] for r in ranks], [r[2 * i + 1][0] for r in ranks])


def _serve(eng, requests, cls):
    for r in requests:
        eng.submit(cls(**r))
    return {r.rid: [int(t) for t in r.out_tokens] for r in eng.run()}


@pytest.fixture(scope="module")
def one_device(models):
    """{case id: (the port's one-device tokens and prefix hits, the JAX
    engine's tokens)} on the same weights."""
    out = {}
    for case, name, paged, kv, _, _ in CASES:
        cfg, jcfg, jp, tp = models[name]
        cls = PagedServeEngine if paged else ServeEngine
        eng = cls(tp, cfg, _rt(kv), **_engine_kw(cfg, paged))
        ours = _serve(eng, _requests(cfg, paged), Request)
        jcls = JPaged if paged else JServe
        jrt = JRuntime(dtype="float32", remat="none", attn_chunk=8,
                       kv_dtype=kv)
        theirs = _serve(jcls(jax.tree.map(jnp.asarray, jp), jcfg, jrt,
                             **_engine_kw(jcfg, paged, JScheduler)),
                        _requests(cfg, paged), JRequest)
        out[case] = (ours, eng.stats.prefix_hits, theirs)
    return out


def _bit_equal(a, b) -> bool:
    return len(a) == len(b) and all(x.shape == y.shape and x.tobytes()
                                    == y.tobytes() for x, y in zip(a, b))


@pytest.mark.parametrize("mesh,case", PARAMS, ids=IDS)
def test_logits_equal_the_base_recipe_bit_for_bit(meshes, mesh, case):
    """Every logits array the host sampled from (each prefill's, each
    forced and each greedy decode step's) equal, bit for bit, to the
    same mesh's under the recipe without the ``data`` split."""
    got, base = _case(meshes, mesh, case)
    assert len(got[0]["logits"]) > NEW + 2       # forced steps included
    assert _bit_equal(got[0]["logits"], base[0]["logits"])


@pytest.mark.parametrize("mesh,case", PARAMS, ids=IDS)
def test_serves_the_one_device_tokens(meshes, one_device, mesh, case):
    """Rank 0's tokens are the port's one-device engine's, which are the
    JAX engine's; every rank serves rank 0's tokens and keeps its
    stats; the paged engine hits its prefix cache as one device does
    (the dense model's at least once)."""
    got, _ = _case(meshes, mesh, case)
    ours, hits, theirs = one_device[case[0]]
    assert ours == theirs
    assert len(got) == math.prod(mesh)
    assert got[0]["tokens"] == ours
    for r in got[1:]:
        assert r["tokens"] == got[0]["tokens"], r["rank"]
        assert r["stats"] == got[0]["stats"], r["rank"]
    if case[2]:
        assert got[0]["stats"]["prefix_hits"] == hits
    if case[0] == "dense-paged":
        assert hits > 0


@pytest.mark.parametrize("mesh,case", PARAMS, ids=IDS)
def test_each_rank_holds_the_capacity_bytes(models, meshes, mesh, case):
    """Each rank's parameter and cache bytes are ``capacity``'s under the
    case's recipe; its parameters are at most the base recipe's over
    ``data`` plus the leaves no ``embed`` dim splits (norm scales,
    biases)."""
    _, name, paged, kv, recipe, base = case
    cfg = models[name][0]
    got, base_recs = _case(meshes, mesh, case)
    sizes = {"data": mesh[0], "model": mesh[1]}
    kw = dict(mesh=sizes, recipe=recipe, n_slots=N_SLOTS, max_len=MAX_LEN,
              dtype="float32", kv_dtype=kv)
    if paged:
        kw.update(page_size=PAGE, page_budget=default_page_budget(
            cfg, N_SLOTS, MAX_LEN, PAGE, "float32", kv))
    rep = capacity(cfg, **kw)
    base_bytes = capacity(cfg, **dict(kw, recipe=base)).params_bytes
    for r in got:
        assert r["params_bytes"] == rep.params_bytes, r["rank"]
        assert r["cache_bytes"] == rep.cache_bytes, r["rank"]
    assert {r["params_bytes"] for r in base_recs} == {base_bytes}
    assert base_bytes / 2 < rep.params_bytes < 0.55 * base_bytes


@pytest.mark.parametrize("recipe", sorted(RECIPES) + [
    f"{name}+zero3" for name in sorted(RECIPES)])
def test_every_recipes_blocks_are_capacitys(models, recipe):
    """Host only: a rank's blocks of every family's tree (``shard_tree``
    on a dict mesh, as each engine copies them) hold ``capacity``'s
    parameter bytes under every recipe and its ``+zero3`` form."""
    for name in ("minicpm", "moe-e5", "mamba2", "zamba2"):
        cfg, _, _, tp = models[name]
        for mesh in ({"data": 2, "model": 2}, {"data": 2, "model": 1}):
            blocks = shard_tree(tp, axes_tree(cfg), get_recipe(recipe),
                                mesh, cfg)
            got = sum(t.numel() * t.element_size()
                      for t in tree_leaves(blocks))
            assert got == capacity(cfg, mesh=mesh, recipe=recipe,
                                   n_slots=N_SLOTS, max_len=MAX_LEN,
                                   dtype="float32").params_bytes, (name,
                                                                   mesh)


def test_recipe_names_resolve():
    assert get_recipe("decode+zero3").rules["embed"] == ("data",)
    assert get_recipe("WS_seq+zero3").rules["heads"] is None
    with pytest.raises(ValueError, match="unknown recipe"):
        get_recipe("WS+zero2")


@pytest.mark.parametrize("name", FORWARD)
def test_mesh_forward_under_ws_zero3(models, meshes, name):
    """``mesh_forward`` under ``WS+zero3`` at (2, 2): the logits of
    ``WS`` bit for bit, held to the JAX forward, each rank's parameters
    ``capacity``'s."""
    cfg, jcfg, jp, _ = models[name]
    i = 2 * len(CASES) + 2 * FORWARD.index(name)
    ranks = meshes[(2, 2)]
    got, base = ranks[0][i][0], ranks[0][i + 1][0]
    assert got["recipe"] == "WS+zero3" and base["recipe"] == "WS"
    assert got["logits"].numpy().tobytes() == base["logits"].numpy().tobytes()
    batch = _frames(cfg)
    want, _ = jforward(jax.tree.map(jnp.asarray, jp), jcfg,
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       JRuntime(dtype="float32", remat="none",
                                attn_chunk=8))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                               **F32_TOL)
    rep = capacity(cfg, mesh={"data": 2, "model": 2}, recipe="WS+zero3",
                   n_slots=4, max_len=12, dtype="float32")
    assert {r[i][0]["params_bytes"] for r in ranks} == {rep.params_bytes}


@pytest.mark.parametrize("how", BROKEN)
def test_a_broken_gather_breaks_the_bit_equality(meshes, how):
    """A gather over ``data`` that reorders its blocks or drops one
    serves logits that differ from the base recipe's: the equality
    above would fail on it."""
    got, base = _case(meshes, (2, 1), CASES[0])
    i = 2 * len(CASES) + BROKEN.index(how)
    broken = meshes[(2, 1)][0][i][0]
    assert _bit_equal(got[0]["logits"], base[0]["logits"])
    assert not _bit_equal(broken["logits"], base[0]["logits"])


_REFERENCE = """
import json, numpy as np, jax
from repro.configs import ARCHS, smoke_config
from repro.dist.sharding import IS_RECIPE
from repro.launch.mesh import make_mesh
from repro.models import init_params
from repro.models.model import ModelRuntime
from repro.serve import Request, Scheduler, ShardedServeEngine

cfg = smoke_config(ARCHS["minicpm-2b"])
rt = ModelRuntime(dtype="float32", remat="none", attn_chunk=8)
params = init_params(jax.random.PRNGKey(0), cfg)
eng = ShardedServeEngine(
    params, cfg, rt, make_mesh((2, 2), ("data", "model")), recipe=IS_RECIPE,
    n_slots={n_slots}, max_len={max_len},
    scheduler=Scheduler(cfg=cfg, max_len={max_len}, buckets={buckets}))
for i in range(6):
    prompt = (np.arange(9 + i) * 3 + i).astype(np.int32) % cfg.vocab_size
    eng.submit(Request(rid=i, prompt=prompt, max_new_tokens={new}))
print(json.dumps({{r.rid: [int(t) for t in r.out_tokens] for r in eng.run()}}))
"""


def test_reference_sharded_engine_under_is(meshes):
    """The JAX package's ``ShardedServeEngine(recipe=IS_RECIPE)`` at
    (2, 2), in a subprocess with four forced host devices, serves the
    port's ``IS`` tokens on the same weights and requests."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    code = _REFERENCE.format(n_slots=N_SLOTS, max_len=MAX_LEN,
                             buckets=BUCKETS, new=NEW)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    want = {int(k): v for k, v in
            json.loads(out.stdout.strip().splitlines()[-1]).items()}
    got, _ = _case(meshes, (2, 2), CASES[0])
    assert CASES[0][4] == "IS" and got[0]["tokens"] == want
