"""The SSM, hybrid and audio families on a mesh: CPU ranks over ``gloo``,
smoke size, f32, held to the JAX package's one-device functions (weights
crossed through numpy).

* serving ``mamba2-1.3b`` (8 SSD heads of 16) at (1, 2) and (2, 4), and
  the hybrid ``zamba2-2.7b`` (4 layers, a shared block every 2) at
  (2, 2), contiguous and paged, f32 and int8 KV: every rank's tokens the
  JAX engine's, its bytes the sharded capacity model's;
* two train steps of mamba2 under its launcher recipe (IS_seq) and of
  zamba2 under IS at (2, 2): loss, ce, gradient norm, step 0's gradients
  leaf by leaf (the B/C columns and channels every rank holds among
  them) and the parameters after the steps against the JAX package's
  jitted step; mamba2's state saved from the mesh, read on one device
  and restored onto (1, 2) WS;
* ``hubert-xlarge``'s non-causal forward (frame embeddings) at (1, 2)
  and (2, 2) against the JAX forward's logits;
* the head-aligned Mamba-2 placement, pinned: each rank's ``in_proj``
  columns are its heads' z, x and dt with B and C whole, its ``conv``
  channels its heads' x with B and C, its ``norm``/``out_proj`` rows and
  state its heads'; whole on every rank when the heads do not divide.

Each mesh is one ``run_mesh`` spawn running every job on it in turn
(``torch_mesh_jobs.run_jobs``: the ranks import the port alone).
"""
import filecmp
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
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

from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch.analysis.capacity import (capacity,  # noqa: E402
                                           serve_preflight)
from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.models import ModelRuntime, params_from_numpy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.ssm import ssm_dims  # noqa: E402
from repro_torch.train import AdamWConfig, TrainConfig  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

from torch_mesh_jobs import run_jobs  # noqa: E402

N_SLOTS, MAX_LEN, PAGE = 4, 64, 8
#: tests/test_torch_kernels.py's f32 bar of a forward's logits.
F32_TOL = dict(atol=5e-5, rtol=1e-5)
#: The train bars of tests/test_torch_train_mesh.py.
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
B, S, STEPS = 4, 16, 2
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, schedule="wsd")
MESH_TIMEOUT = 240

ARCH = {"mamba2": "mamba2-1.3b", "zamba2": "zamba2-2.7b",
        "hubert": "hubert-xlarge"}
#: The serving cases of each mesh: (model id, paged, kv dtype).
SERVE = {(1, 2): (("mamba2", False, None),),
         (2, 4): (("mamba2", False, None),),
         (2, 2): (("zamba2", False, None), ("zamba2", True, None),
                  ("zamba2", False, "int8"), ("zamba2", True, "int8"))}
#: The train cases, at (2, 2): (model id, recipe).
TRAIN = (("mamba2", "IS_seq"), ("zamba2", "IS"))
#: The meshes hubert's forward runs on.
FORWARD = ((1, 2), (2, 2))
SERVE_IDS = [f"{m[0]}x{m[1]}-{n}-{'paged' if p else 'contiguous'}"
             f"-{kv or 'f32'}" for m, cases in SERVE.items()
             for n, p, kv in cases]


@pytest.fixture(scope="module")
def models():
    """{model id: (port cfg, jax cfg, jax params as numpy, port params)}."""
    out = {}
    for name, arch in ARCH.items():
        jcfg = jax_smoke(JAX_ARCHS[arch])
        cfg = smoke_config(ARCHS[arch])
        jp = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg))
        out[name] = (cfg, jcfg, jp, params_from_numpy(cfg, jp, device="cpu"))
    return out


def _requests(cfg, paged):
    """tests/test_multidevice.py's prompts: short arithmetic ones, or a
    shared 16-token system prompt for the paged engine."""
    if not paged:
        prompts = [(np.arange(3 + i) * 3 + i).astype(np.int32)
                   % cfg.vocab_size for i in range(6)]
    else:
        rng = np.random.default_rng(0)
        system = rng.integers(0, cfg.vocab_size, 16)
        prompts = [np.concatenate([system, rng.integers(
            0, cfg.vocab_size, 3 + i)]).astype(np.int32) for i in range(6)]
    return [dict(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]


def _engine_kw(paged):
    kw = dict(n_slots=N_SLOTS, max_len=MAX_LEN)
    if paged:
        kw["page_size"] = PAGE
    return kw


def _rt(kv=None):
    return ModelRuntime(dtype="float32", remat="none", attn_chunk=8,
                        device="cpu", kv_dtype=kv)


def _jrt(kv=None):
    return JRuntime(dtype="float32", remat="none", attn_chunk=8,
                    kv_dtype=kv)


def _batches(cfg):
    data = SyntheticLMData(S, B, cfg.vocab_size, seed=3)
    return [data.batch_at(i) for i in range(STEPS)]


def _frames(cfg):
    """hubert's stubbed frame embeddings, a global batch of B rows."""
    rng = np.random.default_rng(7)
    return {"embeds": rng.standard_normal((B, S, cfg.d_model))
            .astype(np.float32)}


@pytest.fixture(scope="module")
def jax_tokens(models):
    """{(model id, paged, kv): the JAX engine's tokens of each request}."""
    out = {}
    for name, paged, kv in {c for cases in SERVE.values() for c in cases}:
        cfg, jcfg, jp, _ = models[name]
        cls = JPaged if paged else JServe
        eng = cls(jax.tree.map(jnp.asarray, jp), jcfg, _jrt(kv),
                  **_engine_kw(paged))
        for r in _requests(cfg, paged):
            eng.submit(JRequest(**r))
        out[name, paged, kv] = {r.rid: [int(t) for t in r.out_tokens]
                                for r in eng.run()}
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ssm_mesh_ckpt"))


@pytest.fixture(scope="module")
def meshes(models, ckpt_dir):
    """{mesh: every rank's job results}: one spawn a mesh, its serving
    cases, then (at (2, 2)) the train runs, mamba2's state saved from
    the mesh, (at (1, 2)) that checkpoint restored under WS and saved
    again, then hubert's forward."""
    out = {}
    for mesh in ((2, 2), (2, 4), (1, 2)):
        jobs = []
        for name, paged, kv in SERVE.get(mesh, ()):
            cfg, _, _, tp = models[name]
            jobs.append(("serve", (tp, cfg, [dict(
                rt=_rt(kv), requests=_requests(cfg, paged),
                engine_kw=_engine_kw(paged), paged=paged)])))
        tc = TrainConfig(opt=AdamWConfig(**OPT))
        if mesh == (2, 2):
            jobs.append(("train", ([dict(
                cfg=models[name][0], params=models[name][3], rt=_rt(),
                tc=tc, recipe=recipe, batches=_batches(models[name][0]),
                grads=True, gather=True,
                **({"save": (ckpt_dir, STEPS)} if name == "mamba2" else {}))
                for name, recipe in TRAIN],)))
        if mesh == (1, 2):
            cfg = models["mamba2"][0]
            jobs.append(("train", ([dict(
                cfg=cfg, params=None, rt=_rt(), tc=tc, recipe="WS",
                batches=_batches(cfg)[:1], restore=(ckpt_dir, STEPS),
                save_restored=os.path.join(ckpt_dir, "resaved"))],)))
        if mesh in FORWARD:
            cfg, _, _, tp = models["hubert"]
            jobs.append(("forward", (tp, cfg, [dict(rt=_rt(),
                                                    batch=_frames(cfg))])))
        out[mesh] = run_mesh(run_jobs, mesh, jobs, devices="cpu",
                             timeout=MESH_TIMEOUT)
    return out


@pytest.fixture(scope="module")
def reference(models):
    """{model id: the JAX package's jitted one-device step on the global
    batches: per step its metrics, step 0's gradients, the parameters
    after the steps}."""
    out = {}
    for name, _ in TRAIN:
        cfg, jcfg, jp, _ = models[name]
        batches = [jax.tree.map(jnp.asarray, b) for b in _batches(cfg)]
        p = jax.tree.map(jnp.asarray, jp)
        grads = jax.jit(jax.grad(
            lambda p, b: jloss(p, jcfg, b, _jrt())[0]))(p, batches[0])
        step = jax.jit(jmake_step(jcfg, _jrt(), JTrain(opt=JAdamW(**OPT))))
        state, metrics = jinit_state(p), []
        for b in batches:
            state, mt = step(state, b)
            metrics.append({k: float(v) for k, v in mt.items()})
        out[name] = dict(metrics=metrics,
                         grads=jax.tree.map(np.asarray, grads),
                         params=jax.tree.map(np.asarray, state["params"]))
    return out


@pytest.mark.parametrize("mesh,name,paged,kv", [
    (m, *c) for m, cases in SERVE.items() for c in cases], ids=SERVE_IDS)
def test_sharded_engines_serve_the_jax_tokens(models, jax_tokens, meshes,
                                              mesh, name, paged, kv):
    """Every rank serves the JAX engine's tokens; each rank's parameter
    and cache bytes are the sharded capacity model's to the byte (the
    SSM state at its heads, the hybrid's K/V at its heads)."""
    cfg = models[name][0]
    i = SERVE[mesh].index((name, paged, kv))
    ranks = [r[i][0] for r in meshes[mesh]]
    assert len(ranks) == math.prod(mesh)
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert ranks[0]["tokens"] == jax_tokens[name, paged, kv]
    for r in ranks[1:]:
        assert r["tokens"] == ranks[0]["tokens"], r["rank"]
        assert r["stats"] == ranks[0]["stats"], r["rank"]
    sizes = {"data": mesh[0], "model": mesh[1]}
    rep = serve_preflight(cfg, n_slots=N_SLOTS, max_len=MAX_LEN,
                          page_size=PAGE if paged else None, mesh=sizes,
                          dtype="float32", param_dtype="float32",
                          kv_dtype=kv)
    for r in ranks:
        assert r["params_bytes"] == rep.params_bytes
        assert r["cache_bytes"] == rep.cache_bytes
        pl = sh.Placement(cfg, sh.DECODE_RECIPE, sizes, coords=r["coords"])
        assert r["cache_shapes"]["ssm"][2] == pl.ssm_heads \
            == ssm_dims(cfg)["nh"] // mesh[1]


@pytest.mark.parametrize("name,recipe", TRAIN, ids=[c[0] for c in TRAIN])
def test_mesh_train_step_matches_jax(meshes, reference, models, name,
                                     recipe):
    """Two steps at (2, 2) against the JAX package's two one-device
    steps: loss, ce, gradient norm and learning rate per step, step 0's
    gradients per leaf, the parameters after the steps; every rank
    reports rank 0's scalars, holds its blocks of the state, and its
    state bytes are the sharded capacity model's."""
    ranks = [r[-2][TRAIN.index((name, recipe))] for r in meshes[(2, 2)]]
    ref = reference[name]
    r0 = ranks[0]
    assert r0["recipe"] == recipe
    for i, jm in enumerate(ref["metrics"]):
        assert abs(r0["loss"][i] - jm["loss"]) <= LOSS_RTOL * abs(jm["loss"])
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
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert r[k] == r0[k], (r["rank"], k)
        assert r["blocks_equal"], r["rank"]
    rep = capacity(models[name][0], ShapeConfig("train", S, B, "train"),
                   mesh={"data": 2, "model": 2}, recipe=recipe)
    assert {r["state_bytes"] for r in ranks} == {rep.params_bytes * 3 + 4}


def test_ssm_checkpoint_from_a_mesh_restores_onto_another(meshes,
                                                          ckpt_dir):
    """mamba2's state saved from the (2, 2) IS_seq mesh (each rank
    writing its blocks: the head-aligned columns and channels as lists
    of indices, B/C by their first holder) is the whole state one device
    reads; restored onto (1, 2) WS (other blocks of every mixer leaf)
    and saved again from there, every file equals the one read, byte
    for byte."""
    state = meshes[(2, 2)][0][-2][TRAIN.index(("mamba2", "IS_seq"))][
        "state"]
    like = {"params": state["params"],
            "opt": {"mu": state["params"], "nu": state["params"],
                    "step": state["opt"]["step"]}}
    back = tckpt.restore(ckpt_dir, STEPS, like)
    for (path, got), (_, want) in zip(tree_items(back), tree_items(state)):
        assert torch.equal(got, want), path
    restored = [r[-2][0] for r in meshes[(1, 2)]]
    assert all(r["recipe"] == "WS" and "restore_s" in r for r in restored)
    step = f"step_{STEPS:08d}"
    names = sorted(os.listdir(os.path.join(ckpt_dir, step)))
    again = os.path.join(ckpt_dir, "resaved", step)
    assert names == sorted(os.listdir(again))
    for n in names:
        assert filecmp.cmp(os.path.join(ckpt_dir, step, n),
                           os.path.join(again, n), shallow=False), n


@pytest.mark.parametrize("mesh", FORWARD, ids=lambda m: f"{m[0]}x{m[1]}")
def test_hubert_forward_matches_jax(models, meshes, mesh):
    """hubert's non-causal forward over frame embeddings on the mesh
    (each data rank its rows, the 16 heads and the vocabulary split over
    ``model``) gives the JAX package's one-device logits."""
    cfg, jcfg, jp, _ = models["hubert"]
    batch = _frames(cfg)
    want, _ = jforward(jax.tree.map(jnp.asarray, jp), jcfg,
                       jax.tree.map(jnp.asarray, batch), _jrt())
    for r in meshes[mesh]:
        rec = r[-1][0]
        assert rec["recipe"] == "WS"
        torch.testing.assert_close(rec["logits"],
                                   torch.from_numpy(np.array(want)),
                                   **F32_TOL)
        rep = capacity(cfg, ShapeConfig("prefill", S, B, "prefill"),
                       mesh={"data": mesh[0], "model": mesh[1]},
                       dtype="float32")
        assert rec["params_bytes"] == rep.params_bytes


def test_mixer_placement_is_head_aligned():
    """mamba2 smoke (8 heads of 16, one group of state 16) at ``model``
    2: rank r's ``in_proj`` columns are z, x and dt of its heads 4r..4r+3
    and B, C whole; its ``conv`` channels x of its heads, then B and C;
    its ``A_log``/``D``/``dt_bias``, ``norm`` and ``out_proj`` rows and
    its state its heads'. The spec's contiguous block of ``in_proj``
    (columns 148r..148r+147) would mix z, x, B, C and dt."""
    cfg = smoke_config(get_arch("mamba2-1.3b"))
    dm = ssm_dims(cfg)
    di, nh, hp, N = dm["di"], dm["nh"], dm["hp"], dm["N"]
    axes = dict(tree_items(tmodel.axes_tree(cfg)))
    defs = dict(tree_items(tmodel.param_defs(cfg)))
    cs = tmodel.cache_spec(cfg, 4, 64)
    for r in range(2):
        pl = sh.Placement(cfg, sh.DECODE_RECIPE, {"data": 1, "model": 2},
                          coords={"data": 0, "model": r})
        h = list(range(4 * r * hp, 4 * (r + 1) * hp))
        bc = list(range(di, di + 2 * N))

        def sel(name):
            key = ("blocks", "ssm", name)
            return pl.slices(axes[key], defs[key].shape, record=False)[-1]
        assert sel("in_proj") == h + [di + c for c in h] + \
            [di + c for c in bc] + list(range(2 * di + 2 * N + 4 * r,
                                              2 * di + 2 * N + 4 * r + 4))
        assert sel("conv_w") == sel("conv_b") == h + bc
        for name in ("A_log", "D", "dt_bias"):
            assert sel(name) == slice(4 * r, 4 * r + 4)
        assert sel("norm") == slice(h[0], h[-1] + 1)
        out = pl.slices(axes[("blocks", "ssm", "out_proj")],
                        defs[("blocks", "ssm", "out_proj")].shape,
                        record=False)
        assert out[-2:] == (slice(h[0], h[-1] + 1), slice(0, cfg.d_model))
        conv = pl.local_shape(tmodel.CACHE_AXES["conv"], cs["conv"][0])
        state = pl.local_shape(tmodel.CACHE_AXES["ssm"], cs["ssm"][0])
        assert conv[-1] == di // 2 + 2 * N and state[2] == nh // 2
        # each element's holders (the global norm's weights): B/C's
        # columns every rank, its heads' z, x and dt this rank alone
        key = ("blocks", "ssm", "in_proj")
        want = [1.0] * (2 * len(h)) + [2.0] * (2 * N) + [1.0] * 4
        assert pl.copies(axes[key], defs[key].shape).reshape(-1).tolist() \
            == want
    # heads that do not divide keep the mixer whole on every rank
    pl = sh.Placement(cfg, sh.DECODE_RECIPE, {"data": 1, "model": 16})
    assert not pl.ssm_split
    key = ("blocks", "ssm", "in_proj")
    assert pl.local_shape(axes[key], defs[key].shape) == defs[key].shape


@pytest.mark.parametrize("arch,model,heads", [
    ("mamba2-1.3b", 2, 32), ("mamba2-1.3b", 4, 16), ("zamba2-2.7b", 2, 40)])
def test_full_width_mixer_blocks(arch, model, heads):
    """The SSD heads the scan kernel runs a rank at full width (mamba2's
    64 over ``model`` 2 and 4, zamba2's 80 over 2), with B and C of the
    one group whole: ``in_proj`` holds 2 x heads x 64 + 2 x N + heads
    columns a rank."""
    cfg = get_arch(arch)
    dm = ssm_dims(cfg)
    pl = sh.Placement(cfg, sh.DECODE_RECIPE, {"data": 1, "model": model})
    assert pl.ssm_split and pl.ssm_heads == heads
    axes = dict(tree_items(tmodel.axes_tree(cfg)))
    defs = dict(tree_items(tmodel.param_defs(cfg)))
    key = ("blocks", "ssm", "in_proj")
    assert pl.local_shape(axes[key], defs[key].shape)[-1] == \
        2 * heads * dm["hp"] + 2 * dm["N"] + heads
