"""The sharded engines on CPU ranks over ``gloo``, at ``smoke_config``
(minicpm-2b) in f32, held token for token against one device.

The parity chain has two links here: the port's one-device engines serve
the same tokens as the JAX ``repro.serve`` engines on the same weights
(crossed through numpy), and ``ShardedServeEngine`` /
``ShardedPagedServeEngine`` at meshes (2, 4) and (2, 2) serve the same
tokens as the port's one-device engines: the reference test's prompts
(``tests/test_multidevice.py``), contiguous, paged with the prefix cache
on (``prefix_hits > 0``) and with int8 KV. Every rank's tokens equal
rank 0's; each rank's cache leaves are the predicted strict blocks of
the whole cache and its bytes the sharded capacity model's.

Each mesh is one ``run_mesh`` spawn (one thread a rank, its own
timeout) serving every case in turn; the tests read its results.
"""
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.serve import PagedServeEngine as JPaged  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.dist.sharding import (DECODE_RECIPE,  # noqa: E402
                                       Placement)
from repro_torch.launch.mesh import pick_backend, run_mesh  # noqa: E402
from repro_torch.models import ModelRuntime, params_from_numpy  # noqa: E402
from repro_torch.models.model import (CACHE_AXES,  # noqa: E402
                                      PAGED_CACHE_AXES, cache_spec,
                                      paged_cache_spec)
from repro_torch.serve import (PagedServeEngine, Request,  # noqa: E402
                               ServeEngine)
from repro_torch.serve.sharded import mesh_serve  # noqa: E402

cap = importlib.import_module("repro_torch.analysis.capacity")

CFG = smoke_config(ARCHS["minicpm-2b"])
JCFG = jax_smoke(JAX_ARCHS["minicpm-2b"])
N_SLOTS, MAX_LEN, PAGE = 4, 64, 8
#: Seconds a mesh's spawn may take, all its cases served.
MESH_TIMEOUT = 240
#: (name, paged, kv dtype) of each case, served on both meshes.
CASES = (("contiguous", False, None), ("paged", True, None),
         ("contiguous-int8", False, "int8"), ("paged-int8", True, "int8"))
MESH_CASES = {(2, 4): CASES, (2, 2): CASES}


def _prompts(paged: bool):
    """The reference test's prompts: short arithmetic ones for the
    contiguous engine, a shared 16-token system prompt for the paged."""
    if not paged:
        return [(np.arange(3 + i) * 3 + i).astype(np.int32)
                % CFG.vocab_size for i in range(6)]
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, CFG.vocab_size, 16)
    return [np.concatenate([sys_prompt,
                            rng.integers(0, CFG.vocab_size, 3 + i)])
            .astype(np.int32) for i in range(6)]


def _requests(paged):
    return [dict(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_prompts(paged))]


def _rt(kv_dtype=None):
    return ModelRuntime(dtype="float32", remat="none", attn_chunk=16,
                        device="cpu", kv_dtype=kv_dtype)


def _engine_kw(paged):
    kw = dict(n_slots=N_SLOTS, max_len=MAX_LEN)
    if paged:
        kw["page_size"] = PAGE
    return kw


def _serve(eng, requests, cls=Request):
    for r in requests:
        eng.submit(cls(**r))
    return {r.rid: list(r.out_tokens) for r in eng.run()}


@pytest.fixture(scope="module")
def weights():
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(CFG, jax.tree.map(np.asarray, jp),
                                 device="cpu")


@pytest.fixture(scope="module")
def one_device(weights):
    """The port's one-device tokens of every case."""
    _, tp = weights
    out = {}
    for name, paged, kv in CASES:
        cls = PagedServeEngine if paged else ServeEngine
        eng = cls(tp, CFG, _rt(kv), **_engine_kw(paged))
        out[name] = (_serve(eng, _requests(paged)), eng.stats.prefix_hits)
    return out


@pytest.fixture(scope="module")
def meshes(weights):
    """Every mesh's per-rank results, one spawn a mesh."""
    _, tp = weights
    out = {}
    for mesh, cases in MESH_CASES.items():
        runs = [dict(rt=_rt(kv), requests=_requests(paged),
                     engine_kw=_engine_kw(paged), paged=paged)
                for _, paged, kv in cases]
        ranks = run_mesh(mesh_serve, mesh, tp, CFG, runs, devices="cpu",
                         timeout=MESH_TIMEOUT)
        for i, (name, _, _) in enumerate(cases):
            out[(mesh, name)] = [r[i] for r in ranks]
    return out


@pytest.mark.parametrize("name,paged,kv", CASES, ids=[c[0] for c in CASES])
def test_one_device_engine_matches_jax_engine(weights, one_device, name,
                                              paged, kv):
    jp, _ = weights
    rt = JRuntime(dtype="float32", remat="none", attn_chunk=16, kv_dtype=kv)
    cls = JPaged if paged else JServe
    want = _serve(cls(jp, JCFG, rt, **_engine_kw(paged)), _requests(paged),
                  JRequest)
    assert one_device[name][0] == {k: [int(t) for t in v]
                                   for k, v in want.items()}


MESH_IDS = [f"{m[0]}x{m[1]}-{c[0]}" for m, cs in MESH_CASES.items()
            for c in cs]


@pytest.mark.parametrize("mesh,name,paged,kv", [
    (m, *c) for m, cs in MESH_CASES.items() for c in cs], ids=MESH_IDS)
def test_sharded_engine_serves_one_device_tokens(meshes, one_device, mesh,
                                                 name, paged, kv):
    ranks = meshes[(mesh, name)]
    want, hits = one_device[name]
    assert len(ranks) == math.prod(mesh)
    assert ranks[0]["tokens"] == want
    for r in ranks[1:]:
        assert r["tokens"] == ranks[0]["tokens"], r["rank"]
        assert r["stats"] == ranks[0]["stats"], r["rank"]
    assert {r["backend"] for r in ranks} == {"gloo"}
    if paged:
        assert ranks[0]["stats"]["prefix_hits"] == hits > 0


@pytest.mark.parametrize("mesh,name,paged,kv", [
    (m, *c) for m, cs in MESH_CASES.items() for c in cs], ids=MESH_IDS)
def test_each_rank_holds_its_predicted_block(meshes, mesh, name, paged, kv):
    """Each rank's cache leaf is its predicted block: a strict slice of
    the K/V leaf (its K/V heads; its slots in the contiguous cache), the
    rank's slots its data coordinate's; its parameter and cache bytes
    the sharded capacity model's to the byte."""
    sizes = {"data": mesh[0], "model": mesh[1]}
    rep = cap.serve_preflight(CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                              page_size=PAGE if paged else None, mesh=sizes,
                              dtype="float32", param_dtype="float32",
                              kv_dtype=kv)
    if paged:
        n_pages = cap.default_page_budget(CFG, N_SLOTS, MAX_LEN, PAGE,
                                          "float32", kv)
        spec = paged_cache_spec(CFG, N_SLOTS, n_pages, PAGE, MAX_LEN,
                                "float32", kv)
        axes, kv_leaf = PAGED_CACHE_AXES, "kp"
    else:
        spec = cache_spec(CFG, N_SLOTS, MAX_LEN, "float32", kv)
        axes, kv_leaf = CACHE_AXES, "k"
    per_data = N_SLOTS // mesh[0]
    for r in meshes[(mesh, name)]:
        pl = Placement(CFG, DECODE_RECIPE, sizes, coords=r["coords"])
        want = {k: pl.local_shape(axes[k], s) for k, (s, _) in spec.items()}
        assert r["cache_shapes"] == want
        assert math.prod(want[kv_leaf]) < math.prod(spec[kv_leaf][0])
        d = r["coords"]["data"]
        assert r["slots"] == (d * per_data, (d + 1) * per_data)
        assert r["params_bytes"] == rep.params_bytes
        assert r["cache_bytes"] == rep.cache_bytes


def test_backend_rule():
    assert pick_backend(8, "cpu") == "gloo"
    assert pick_backend(2, ["cuda:0", "cuda:0"]) == "gloo"
    assert pick_backend(2, ["cuda:0", "cuda:1"]) == "nccl"
    assert pick_backend(2, ["cpu", "cuda:1"]) == "gloo"


@pytest.mark.parametrize("stop_first", [False, True])
def test_ranks_fork_from_one_server(stop_first):
    """Ranks fork from a server that imported torch once: a mesh after
    another reuses the running server, one after ``stop_forkserver``
    starts a new one, and either way every rank of the (2, 2) mesh sits
    at its coordinates and sums over each axis's two ranks."""
    from torch_mesh_jobs import rank_sums
    from repro_torch.launch.mesh import stop_forkserver
    run_mesh(rank_sums, (1, 2), torch.zeros(1), devices="cpu",
             timeout=MESH_TIMEOUT)
    if stop_first:
        stop_forkserver()
    got = run_mesh(rank_sums, (2, 2), torch.arange(3.0), devices="cpu",
                   timeout=MESH_TIMEOUT)
    assert got == [(r, {"data": r // 2, "model": r % 2},
                    {"data": [0.0, 2.0, 4.0], "model": [0.0, 2.0, 4.0]})
                   for r in range(4)]


@pytest.mark.parametrize("arch,mesh,recipe,kw,match", [
    ("hubert-xlarge", (1, 2), None, {}, "encoder-only"),
    ("minicpm-2b", (1, 2), "IS+zero2", {}, "unknown recipe"),
    ("minicpm-2b", (2, 1), None, dict(n_slots=3), "does not divide")])
def test_a_rank_failure_stops_the_mesh(weights, arch, mesh, recipe, kw,
                                       match):
    """A rank that raises stops every rank, and its traceback reaches
    the caller (nothing is caught and passed over): an encoder served on
    a mesh, a recipe name no recipe has, slots that do not divide over
    ``data``."""
    cfg = smoke_config(ARCHS[arch])
    params = weights[1] if arch == "minicpm-2b" else {}
    with pytest.raises(RuntimeError, match=match):
        run_mesh(mesh_serve, mesh, params, cfg, [dict(
            rt=_rt(), requests=[], engine_kw=kw, paged=False)], recipe,
            devices="cpu", timeout=MESH_TIMEOUT)
