"""Training on a mesh: the sharded train step on CPU ranks over ``gloo``,
held to one device and to the JAX package, at smoke size in f32.

The statement held: a recipe is placement, not semantics. On every mesh
the step gives the JAX package's one-device loss, ce, gradient norm,
gradients (per leaf, assembled whole) and updated parameters, for two
steps, within ``tests/test_torch_train.py``'s f32 tolerances:
``chatglm3-6b`` (the reference test's arch: 2 K/V heads, so at
``model`` 4 each K/V head is held by two ranks) under IS at (2, 4), the
reference test's mesh; WS and WS_seq at (2, 2); IS_seq at (1, 2);
``minicpm-2b`` under IS at (2, 2), (4, 1) and (2, 2, 1) over ``(pod,
data, model)``, there also with ``microbatches=2`` (2 rows a
microbatch: split over ``pod`` alone, each row held by both ``data``
ranks of its pod); ``qwen2-vl-7b`` (``embeds``,
M-RoPE) under IS at (2, 2); ``microbatches=2`` at (2, 2);
``stablelm-12b`` (qk-norm: its scales enter the split heads through an
f) under WS at (1, 2) and ``starcoder2-3b`` (LayerNorm, whose bias is
split over ``data`` too) under IS at (2, 2). Every rank's
scalars equal rank 0's, every rank's state is its ``Placement`` blocks
of the assembled state, and its bytes the sharded capacity model's.

Besides: ``pow2_mesh_shape`` and ``stage_split`` against the reference,
GPipe on a ``("stage", "data")`` mesh against the sequential form
(outputs and gradients), ``make_global_batch``, checkpoints written by
a mesh (the files of a one-device save; the JAX package reads them) and
read onto another mesh (``restore_elastic``, from the JAX package's
files too), the launcher's ``--mesh``/``--recipe`` and its resume on
another mesh, and the sharded state of the MoE, SSM, hybrid and audio
families.

Each mesh is one ``run_mesh`` spawn (one thread a rank, its own
timeout) running every case on it in turn; the tests read its results.
"""
import filecmp
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as jckpt  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.dist.fault import pow2_mesh_shape as jpow2  # noqa: E402
from repro.dist.pipeline import stage_split as jstage_split  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train.loop import init_state as jinit_state  # noqa: E402
from repro.train.loop import make_train_step as jmake_step  # noqa: E402

from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch.analysis.capacity import capacity  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.dist import (RECIPES, Placement, Recipe,  # noqa: E402
                              TreeLayout, pow2_mesh_shape, stage_split)
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.models import ModelRuntime, params_from_numpy  # noqa: E402
from repro_torch.models.model import axes_tree  # noqa: E402
from repro_torch.train import AdamWConfig, TrainConfig  # noqa: E402
from repro_torch.train.loop import state_layout  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

#: tests/test_torch_train.py's f32 bars: losses 1e-5 relative, every
#: leaf's gradient max|d| <= 1e-4 max|g|, the scalars 1e-5.
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
B, S, STEPS = 4, 16, 2
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, schedule="wsd")
#: Seconds a mesh's spawn may take, all its cases run.
MESH_TIMEOUT = 240

#: (case id, arch, recipe, mesh, microbatches) of the train-step cases.
CASES = [
    ("chatglm-IS-2x4", "chatglm3-6b", "IS", (2, 4), 1),
    ("chatglm-WS-2x2", "chatglm3-6b", "WS", (2, 2), 1),
    ("chatglm-WS_seq-2x2", "chatglm3-6b", "WS_seq", (2, 2), 1),
    ("chatglm-IS_seq-1x2", "chatglm3-6b", "IS_seq", (1, 2), 1),
    ("minicpm-IS-2x2", "minicpm-2b", "IS", (2, 2), 1),
    ("minicpm-IS-4x1", "minicpm-2b", "IS", (4, 1), 1),
    ("qwen2vl-IS-2x2", "qwen2-vl-7b", "IS", (2, 2), 1),
    ("chatglm-IS-2x2-micro2", "chatglm3-6b", "IS", (2, 2), 2),
    ("stablelm-WS-1x2", "stablelm-12b", "WS", (1, 2), 1),
    ("starcoder2-IS-2x2", "starcoder2-3b", "IS", (2, 2), 1),
    # (pod, data, model): the batch over pod x data, the IS embedding's
    # gradient summed over pod after its data reduce-scatter; two steps,
    # so that pods whose masters parted after step 0 would show
    ("minicpm-IS-2x2x1", "minicpm-2b", "IS", (2, 2, 1), 1),
    # microbatches of 2 rows over pod 2 x data 2: each splits over pod
    # alone (the first of two equal splits) and the data ranks of a pod
    # hold the same rows
    ("minicpm-IS-2x2x1-micro2", "minicpm-2b", "IS", (2, 2, 1), 2),
]
#: The families the family slice brought to the mesh: each builds its
#: sharded train state on the (2, 2) spawn (the steps themselves are held
#: to the JAX package in tests/test_torch_mesh_moe.py and
#: tests/test_torch_mesh_ssm.py).
FAMILIES = ("qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-2.7b", "hubert-xlarge")


def _rt():
    return ModelRuntime(dtype="float32", remat="none", attn_chunk=8,
                        device="cpu")


def _jrt():
    return JRuntime(dtype="float32", remat="none", attn_chunk=8)


def _tc(m=1):
    return TrainConfig(opt=AdamWConfig(**OPT), microbatches=m)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg):
    data = SyntheticLMData(S, B, cfg.vocab_size, seed=3,
                           frontend=cfg.frontend, d_model=cfg.d_model)
    return [data.batch_at(i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def models():
    """{arch: (cfg, jcfg, jax params as numpy)}."""
    out = {}
    for arch in sorted({c[1] for c in CASES}):
        jcfg = jax_smoke(JAX_ARCHS[arch])
        out[arch] = (smoke_config(ARCHS[arch]), jcfg,
                     _np(jinit(jax.random.PRNGKey(0), jcfg)))
    return out


@pytest.fixture(scope="module")
def reference(models):
    """{(arch, microbatches): the JAX package's one-device jitted train
    step on the global batches: per step its metrics, step 0's
    gradients, the parameters after the steps}."""
    out = {}
    for arch, m in sorted({(c[1], c[4]) for c in CASES}):
        cfg, jcfg, jp = models[arch]
        batches = [jax.tree.map(jnp.asarray, b) for b in _batches(cfg)]
        grads = jax.jit(jax.grad(
            lambda p, b: jloss(p, jcfg, b, _jrt())[0]))(jp, batches[0])
        step = jax.jit(jmake_step(jcfg, _jrt(),
                                  JTrain(opt=JAdamW(**OPT), microbatches=m)))
        state, metrics = jinit_state(jax.tree.map(jnp.asarray, jp)), []
        for b in batches:
            state, mt = step(state, b)
            metrics.append({k: float(v) for k, v in mt.items()})
        out[arch, m] = dict(metrics=metrics, grads=_np(grads),
                            params=_np(state["params"]))
    return out


def _run(case, models, **extra):
    _, arch, recipe, _, m = case
    cfg, _, jp = models[arch]
    run = dict(cfg=cfg, params=params_from_numpy(cfg, jp, device="cpu"),
               rt=_rt(), tc=_tc(m), recipe=recipe, batches=_batches(cfg),
               grads=True, gather=True)
    run.update(extra)
    return run


def _axes(mesh):
    """A mesh shape's axes: (pod, data, model) for three."""
    return ("pod", "data", "model")[-len(mesh):]


def _mesh_ranks(mesh, *args, fn=None, **kw):
    from repro_torch.train.sharded import mesh_train
    return run_mesh(fn or mesh_train, mesh, *args, axes=_axes(mesh),
                    devices="cpu", timeout=MESH_TIMEOUT, **kw)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


@pytest.fixture(scope="module")
def trained(models, ckpt_dir):
    """{case id: every rank's record}: one spawn a mesh. The (2, 4) IS
    state is saved from the mesh (step 2); the (2, 2) spawn also
    restores it under WS."""
    out = {}
    for mesh in ((2, 4), (2, 2), (1, 2), (4, 1), (2, 2, 1)):  # (2, 4) first
        cases = [c for c in CASES if c[3] == mesh]
        runs = []
        for c in cases:
            extra = {}
            if c[0] == "chatglm-IS-2x4":
                extra["save"] = (os.path.join(ckpt_dir, "mesh"), STEPS)
            runs.append(_run(c, models, **extra))
        if mesh == (2, 2):
            chatglm = [c for c in CASES if c[0] == "chatglm-WS-2x2"][0]
            runs.append(_run(chatglm, models, grads=False, restore=(
                os.path.join(ckpt_dir, "mesh"), STEPS),
                save_restored=os.path.join(ckpt_dir, "resaved")))
            cases = cases + [("restored-WS-2x2",) + chatglm[1:]]
        ranks = _mesh_ranks(mesh, runs)
        for i, c in enumerate(cases):
            out[c[0]] = [r[i] for r in ranks]
    return out


def _assert_close_tree(got, want, rtol, what):
    want = dict(tree_items(want))
    got = dict(tree_items(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = np.asarray(got[path], np.float32)
        d = float(np.max(np.abs(g - w)))
        assert d <= rtol * float(np.max(np.abs(w))), (what, path, d)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mesh_train_step_matches_jax(trained, reference, case):
    """Two steps on the mesh against the JAX package's two one-device
    steps: loss, ce, gradient norm and learning rate per step, step 0's
    gradients per leaf, the parameters after the steps."""
    ranks = trained[case[0]]
    ref = reference[case[1], case[4]]
    r0 = ranks[0]
    for i, jm in enumerate(ref["metrics"]):
        assert abs(r0["loss"][i] - jm["loss"]) <= LOSS_RTOL * abs(jm["loss"])
        for k in ("ce", "grad_norm", "lr"):
            np.testing.assert_allclose(r0[k][i], jm[k], rtol=1e-5)
    _assert_close_tree(r0["grads"], ref["grads"], GRAD_RTOL, "grads")
    # the bar of test_train_step_matches_reference, per step: a weight
    # whose gradient is within a few eps of 0 moves by up to a step on
    # an ulp, so each weight is held to a tenth of the steps' sum, and
    # all but 1e-3 of the weights to 1e-6 (counted over the tree: a
    # leaf of 128 norm scales holds one such weight in 128)
    lrs = sum(m["lr"] for m in ref["metrics"])
    want = dict(tree_items(ref["params"]))
    off = total = 0
    for path, got in tree_items(r0["state"]["params"]):
        d = np.abs(got.numpy() - want[path])
        assert d.max() <= 0.1 * lrs, (path, d.max())
        off, total = off + int((d > 1e-6).sum()), total + d.size
    assert off <= 1e-3 * total, (off, total)
    assert int(r0["state"]["opt"]["step"]) == STEPS


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_every_rank_reports_rank0_and_holds_its_blocks(trained, case):
    """Every rank's scalars equal rank 0's bit for bit; every rank's
    state is its blocks of the assembled state; its bytes are the
    sharded capacity model's (f32 masters + two moments + the step)."""
    ranks = trained[case[0]]
    _, arch, recipe, mesh, _ = case
    assert len(ranks) == math.prod(mesh)
    assert {r["backend"] for r in ranks} == {"gloo"}
    for r in ranks:
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert r[k] == ranks[0][k], (r["rank"], k)
        assert r["blocks_equal"], r["rank"]
    cfg = smoke_config(ARCHS[arch])
    rep = capacity(cfg, ShapeConfig("train", S, B, "train"),
                   mesh=dict(zip(_axes(mesh), mesh)), recipe=recipe)
    assert {r["state_bytes"] for r in ranks} == {rep.params_bytes * 3 + 4}
    if math.prod(mesh) > 1:
        whole = sum(np.asarray(t).nbytes for _, t in
                    tree_items(ranks[0]["state"]))
        assert rep.params_bytes * 3 + 4 < whole


def test_mesh_checkpoint_is_a_one_device_checkpoint(trained, ckpt_dir,
                                                   models):
    """The (2, 4) IS state saved from the mesh (each rank writing the
    blocks it owns): the files of a one-device port save of the
    assembled state, byte for byte; the JAX package reads them back
    equal."""
    r0 = trained["chatglm-IS-2x4"][0]
    one = tckpt.save(os.path.join(ckpt_dir, "one"), STEPS, r0["state"])
    _same_files(os.path.join(ckpt_dir, "mesh", f"step_{STEPS:08d}"), one)
    _, jcfg, jp = models["chatglm3-6b"]
    like = jinit_state(jax.tree.map(jnp.asarray, jp))
    back = jckpt.restore(os.path.join(ckpt_dir, "mesh"), STEPS, like)
    for (path, want), got in zip(tree_items(r0["state"]),
                                 jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy(),
                                      err_msg=str(path))


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "_COMPLETE" in names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


def test_restore_elastic_onto_another_mesh(trained, ckpt_dir):
    """The (2, 4) IS checkpoint read onto (2, 2) WS: saved again from
    (2, 2), every file equals the one it was read from, byte for byte;
    the step after it runs on every rank alike."""
    ranks = trained["restored-WS-2x2"]
    step = f"step_{STEPS:08d}"
    _same_files(os.path.join(ckpt_dir, "mesh", step),
                os.path.join(ckpt_dir, "resaved", step))
    assert all(r["blocks_equal"] for r in ranks)
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
        assert all(math.isfinite(x) for x in r["loss"])


def test_restore_elastic_reads_the_reference_files(global_batches):
    """The reference test's tree, written by the JAX package (as from
    its (8,) ``data`` mesh: the files hold whole arrays), restored onto
    (2, 2): each rank's block is its numpy slice (``w`` over (data,
    model), ``b`` over model)."""
    w, b = np.arange(64.0, dtype=np.float32).reshape(8, 8), np.arange(
        8.0, dtype=np.float32)
    for r in global_batches[1][(2, 2)]:
        d, m = r["coords"]["data"], r["coords"]["model"]
        np.testing.assert_array_equal(r["w"].numpy(),
                                      w[4 * d:4 * d + 4, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(r["b"].numpy(), b[4 * m:4 * m + 4])


# ---------------------------------------------------------------------------
# Host-only: the re-plan, stage_split, the placement's training facts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_model", [1, 2, 4, 16])
def test_pow2_mesh_shape_matches_reference(max_model):
    for chips in range(1, 301):
        assert pow2_mesh_shape(chips, max_model) == jpow2(chips, max_model)


def test_stage_split_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((8, 4, 4)).astype(np.float32),
            "sub": {"b": rng.standard_normal((8, 3)).astype(np.float32)}}
    want = jstage_split(tree, 4)
    got = stage_split(tree, 4)
    for (path, g), w in zip(tree_items(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
    with pytest.raises(ValueError, match="not divisible"):
        stage_split(tree, 3)


def test_seq_recipes_keep_the_attention_whole():
    """The departure pinned: under ``*_seq`` (and wherever the heads do
    not divide over ``model``) the attention runs whole on every rank,
    where the reference splits the query rows; the MLP and the
    vocabulary still split. Under WS the heads split, and 2 K/V heads
    over 4 ranks are each held by a pair of ranks, whose gradients sum
    over that pair."""
    cfg = smoke_config(ARCHS["chatglm3-6b"])
    axes = axes_tree(cfg)["blocks"]
    d, nq, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for name in ("WS_seq", "IS_seq"):
        pl = Placement(cfg, RECIPES[name], {"data": 2, "model": 2})
        assert not pl.heads_split and pl.ffn_split and pl.vocab_split
        assert pl.local_shape(axes["wq"], (2, d, nq * hd))[-1] == nq * hd
        assert pl.copies(axes["wq"], (2, d, nq * hd)) == (
            2 if name == "IS_seq" else 4)
    sizes = {"data": 2, "model": 4}
    pl = Placement(cfg, RECIPES["WS"], sizes)
    assert pl.heads_split and pl.kv_shared
    assert pl.kv_groups() == ((0, 1), (2, 3), (4, 5), (6, 7))
    assert pl.copies(axes["wk"], (2, d, nkv * hd)) == 4   # 2 data x pair
    assert pl.copies(axes["wq"], (2, d, nq * hd)) == 2    # data only
    pl = Placement(cfg, RECIPES["IS"], sizes)
    assert pl.split_dim(axes["wq"], (2, d, nq * hd)) == 1
    assert pl.copies(axes["wk"], (2, d, nkv * hd)) == 2   # the pair


def test_state_layout_slices_are_the_shard_blocks():
    """The layout a checkpoint is read with gives each rank exactly the
    blocks ``shard_tree`` copies (the moments as their parameters)."""
    cfg = smoke_config(ARCHS["chatglm3-6b"])
    for name, sizes in (("IS", {"data": 2, "model": 4}),
                        ("WS", {"data": 1, "model": 4})):
        for peer in Placement(cfg, RECIPES[name], sizes).peers():
            lay = state_layout(cfg, peer)
            idx = dict(tree_items(lay.slices()))
            for path, ax in tree_items(axes_tree(cfg)):
                shape = lay.shapes["params"]
                for k in path:
                    shape = shape[k]
                want = peer.slices(ax, shape, record=False)
                assert idx[("params",) + path] == want
                assert idx[("opt", "mu") + path] == want
            assert idx[("opt", "step")] == ()


# ---------------------------------------------------------------------------
# GPipe, the global batch, the refusals: one spawn each mesh
# ---------------------------------------------------------------------------
N_LAYERS, N_STAGES, N_MICRO, MB, D = 8, 4, 6, 2, 16


def _gpipe_inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((N_LAYERS, D, D)) * 0.2).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return w, x


def _gpipe_rank(mesh, w, x):
    from repro_torch.dist.pipeline import pipeline_apply

    def stage_fn(local_w, h):
        for wi in local_w:
            h = torch.tanh(h @ wi)
        return h

    s = mesh.coords["stage"]
    block = stage_split(torch.from_numpy(w), N_STAGES)[s:s + 1]
    block = block.clone().requires_grad_()
    out = pipeline_apply(stage_fn, mesh, N_STAGES)(block, torch.from_numpy(x))
    (g,) = torch.autograd.grad((out ** 2).sum(), [block])
    return dict(coords=dict(mesh.coords), out=out.detach(), grad=g[0])


@pytest.fixture(scope="module")
def gpipe():
    w, x = _gpipe_inputs()
    return w, x, run_mesh(_gpipe_rank, (N_STAGES, 2), w, x,
                          axes=("stage", "data"), devices="cpu",
                          timeout=MESH_TIMEOUT)


def _jax_seq():
    w, x = _gpipe_inputs()

    def seq(wt, h):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, h, wt)[0]

    want = jax.vmap(lambda h: seq(jnp.asarray(w), h))(jnp.asarray(x))
    grad = jax.grad(lambda wt: jnp.sum(jax.vmap(
        lambda h: seq(wt, h))(jnp.asarray(x)) ** 2))(jnp.asarray(w))
    return np.asarray(want), np.asarray(grad)


def test_gpipe_matches_sequential_outputs(gpipe):
    want, _ = _jax_seq()
    for r in gpipe[2]:
        np.testing.assert_allclose(r["out"].numpy(), want, atol=1e-5,
                                   rtol=1e-5)


def test_gpipe_gradients_match_jax_grad(gpipe):
    """The reference checks only that its gradients are finite; the port
    holds each stage's block, unstaged, to ``jax.grad`` of the
    sequential form, on every data replica."""
    _, want = _jax_seq()
    per = N_LAYERS // N_STAGES
    for dcoord in (0, 1):
        got = np.zeros_like(want)
        for r in gpipe[2]:
            if r["coords"]["data"] == dcoord:
                s = r["coords"]["stage"]
                got[s * per:(s + 1) * per] = r["grad"].numpy()
        d = float(np.abs(got - want).max())
        assert d <= 1e-5 * float(np.abs(want).max()), d


def _batch_rank(mesh, batch, cfgs, rt, tc, elastic=None):
    """This rank's rows of ``batch``; for each of ``cfgs`` its train step
    built under IS and the bytes of its sharded state; with ``elastic``
    (a directory), its blocks of the reference tree there."""
    from repro_torch.ckpt import restore_elastic
    from repro_torch.data import make_global_batch
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models import init_params
    from repro_torch.train.loop import make_train_step, shard_state
    out = dict(coords=dict(mesh.coords), rows=make_global_batch(batch, mesh),
               state_bytes=[])
    with use_mesh(mesh):
        for cfg in cfgs:
            assert callable(make_train_step(cfg, rt, tc, "IS"))
            state = shard_state(init_params(cfg, device="cpu"), cfg, "IS")
            out["state_bytes"].append(sum(
                t.numel() * t.element_size()
                for _, t in tree_items(state)))
    if elastic:
        recipe = Recipe("elastic", {"rows": ("data",), "cols": ("model",)})
        layout = TreeLayout(mesh.placement(smoke_config(ARCHS["minicpm-2b"]),
                                           recipe),
                            {"w": ("rows", "cols"), "b": ("cols",)},
                            {"w": (8, 8), "b": (8,)})
        like = {"w": torch.empty(0), "b": torch.empty(0)}
        out.update(restore_elastic(elastic, 1, like, layout.slices()))
    return out


def _global_batch():
    cfg = smoke_config(ARCHS["qwen2-vl-7b"])
    b = SyntheticLMData(S, 8, cfg.vocab_size, seed=4, frontend="patch",
                        d_model=cfg.d_model).batch_at(0)
    rng = np.random.default_rng(5)
    b["positions"] = rng.integers(0, S, (3, 8, S)).astype(np.int32)
    b["tokens"] = rng.integers(0, cfg.vocab_size, (8, S)).astype(np.int32)
    return b


@pytest.fixture(scope="module")
def global_batches(tmp_path_factory):
    """The global batch and every rank's results at (2, 2) (its rows,
    each family's state bytes, its blocks of the reference test's tree as the JAX
    package wrote it) and at (4, 1) (its rows)."""
    b = _global_batch()
    families = [smoke_config(ARCHS[a]) for a in FAMILIES]
    elastic = str(tmp_path_factory.mktemp("reference_tree"))
    jckpt.save(elastic, 1, {"w": jnp.arange(64.0).reshape(8, 8),
                            "b": jnp.arange(8.0)})
    return b, {mesh: run_mesh(_batch_rank, mesh, b,
                              families if mesh == (2, 2) else [], _rt(),
                              _tc(), elastic if mesh == (2, 2) else None,
                              devices="cpu", timeout=MESH_TIMEOUT)
               for mesh in ((2, 2), (4, 1))}


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_make_global_batch_gives_each_rank_its_rows(global_batches, mesh):
    b, ranks = global_batches[0], global_batches[1][mesh]
    per = 8 // mesh[0]
    for r in ranks:
        d = r["coords"]["data"]
        assert set(r["rows"]) == set(b)
        for k, v in b.items():
            want = v[:, d * per:(d + 1) * per] if k == "positions" \
                else v[d * per:(d + 1) * per]
            np.testing.assert_array_equal(r["rows"][k].numpy(), want,
                                          err_msg=k)


def test_other_families_shard_their_state_on_a_mesh(global_batches):
    """The MoE, SSM, hybrid and audio families build their train step
    on the (2, 2) mesh under IS, and each rank's state is the sharded
    capacity model's bytes (f32 masters, two moments, the step)."""
    ranks = global_batches[1][(2, 2)]
    for r in ranks:
        assert len(r["state_bytes"]) == len(FAMILIES)
        for arch, got in zip(FAMILIES, r["state_bytes"]):
            rep = capacity(smoke_config(ARCHS[arch]),
                           ShapeConfig("train", S, B, "train"),
                           mesh={"data": 2, "model": 2}, recipe="IS")
            assert got == rep.params_bytes * 3 + 4, arch


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def _losses(out):
    return [float(ln.split()[3]) for ln in out.splitlines()
            if ln.startswith("step ")]


def test_train_launcher_on_a_cpu_mesh_and_its_resume(capsys, tmp_path):
    """``--mesh 2x2 --recipe IS`` trains to one device's losses; a resume
    on ``--mesh 1x2`` (the default recipe) restores the mesh's
    checkpoint; mamba2 on ``--mesh 1x2`` trains to one device's losses."""
    argv = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
            "--steps", "4", "--batch", "4", "--seq", "16"]
    one = launcher.main(argv)
    capsys.readouterr()
    mesh = launcher.main(argv + ["--mesh", "2x2", "--recipe", "IS",
                                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith(
        "arch=minicpm-2b params=0.1M devices=4 schedule=wsd")
    assert "mesh 2x2 (data, model), recipe IS, over gloo" in out
    np.testing.assert_allclose(mesh["losses"], one["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(_losses(out), one["losses"], atol=1e-4)
    assert tckpt.latest_step(str(tmp_path)) == 4
    resumed = launcher.main(argv + ["--mesh", "1x2", "--ckpt-dir",
                                    str(tmp_path)])
    out = capsys.readouterr().out
    assert "restoring from step 4" in out and resumed["restored"] == 4
    assert resumed["recipe"] == "IS"
    assert all(math.isfinite(x) for x in resumed["losses"])
    # the SSM family on a mesh: mamba2's heads split, one device's losses
    ssm = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
           "--steps", "2", "--batch", "2", "--seq", "16"]
    np.testing.assert_allclose(
        launcher.main(ssm + ["--mesh", "1x2"])["losses"],
        launcher.main(ssm)["losses"], rtol=LOSS_RTOL)


def test_one_device_and_a_mesh_of_one_take_the_same_step(models):
    """A recipe with no mesh is the one-device step, bit for bit."""
    from repro_torch.train.loop import init_state, make_train_step
    cfg, _, jp = models["minicpm-2b"]
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg)[0].items()}
    outs = []
    for recipe in (None, "IS"):
        state = init_state(params_from_numpy(cfg, jp, device="cpu"))
        state, m = make_train_step(cfg, _rt(), _tc(), recipe)(state, batch)
        outs.append((state, float(m["loss"])))
    assert outs[0][1] == outs[1][1]
    for (_, a), (_, b) in zip(tree_items(outs[0][0]), tree_items(outs[1][0])):
        assert torch.equal(a, b)
