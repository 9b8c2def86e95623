"""Port training path against the reference, on the CPU.

Smoke configs of the three ported families (dense ``minicpm-2b``, MoE
``qwen2-moe-a2.7b`` with capacity and dropless routing, SSM
``mamba2-1.3b``) with the reference's weights crossed through
``params_from_numpy``:

* ``cross_entropy`` and ``loss_fn`` (ce, aux, their sum) in f32;
* per-leaf gradients against ``jax.grad`` under both port policies (the
  ``cuda`` impls run forward with the plain versions' autograd as their
  backward): ``max|d| <= 1e-4 * max|g|`` for every leaf, f32;
* ``lr_at`` for the three schedules, one ``adamw_update`` (to 1e-6) and
  one ``make_train_step`` against the reference's; microbatches 1 and
  2; remat ``none``, ``dots`` and ``full`` give equal gradients;
* ``SyntheticLMData`` batches bit for bit, both modes, every frontend;
* checkpoints crossing between the packages in both directions, torn
  writes ignored, the async writer and its garbage collection;
* ``StepMonitor`` and ``Watchdog``; the loss falling on the learnable
  data; the launcher in a subprocess and its restart from a checkpoint;
* the plain SSD scan's gradient where a chunk's decay passes exp's f32
  range: finite in the port, NaN in the reference (which takes the exp
  before masking).

f32 on both sides; the two frameworks sum in different orders, nothing
else differs. Losses agree within 1e-5 relative (the bar
``chip_smoke.py`` holds the card to), learning rates within 1e-6.
"""
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as jckpt  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.data import host_shard as jhost_shard  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models.layers import cross_entropy as jce  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train import lr_at as jlr_at  # noqa: E402
from repro.train.loop import init_state as jinit_state  # noqa: E402
from repro.train.loop import make_train_step as jmake_step  # noqa: E402
from repro.train.optim import adamw_update as jadamw  # noqa: E402

from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.data import SyntheticLMData, host_shard  # noqa: E402
from repro_torch.dist import StepMonitor, Watchdog  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import (ModelRuntime, init_params,  # noqa: E402
                                loss_fn, params_from_numpy)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import cross_entropy  # noqa: E402
from repro_torch.train import (AdamWConfig, TrainConfig,  # noqa: E402
                               adamw_update, lr_at, train_loop)
from repro_torch.train.loop import (init_state, make_train_step,  # noqa
                                    value_and_grad)
from repro_torch.tree import tree_items, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: (arch, dropless): the families and both MoE routings.
CASES = [("minicpm-2b", False), ("qwen2-moe-a2.7b", False),
         ("qwen2-moe-a2.7b", True), ("mamba2-1.3b", False)]
POLICIES = {"torch": D.TORCH_POLICY, "cuda": D.CUDA_POLICY}
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
B, S = 2, 16


def _jrt(dropless=False):
    return JRuntime(dtype="float32", remat="none", attn_chunk=8,
                    moe_dropless=dropless)


def _rt(dropless=False, policy="torch", remat="none"):
    return ModelRuntime(dtype="float32", attn_chunk=8, device="cpu",
                        moe_dropless=dropless, kernels=POLICIES[policy],
                        remat=remat)


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """{arch: (cfg, jcfg, jax params)} at smoke size."""
    out = {}
    for name in sorted({a for a, _ in CASES}):
        cfg, jcfg = smoke_config(ARCHS[name]), jax_smoke(JAX_ARCHS[name])
        out[name] = (cfg, jcfg, jinit(jax.random.PRNGKey(0), jcfg))
    return out


@pytest.fixture(scope="module")
def jax_grads(models):
    """{(arch, dropless): (loss, metrics, grads)} of the reference."""
    out = {}
    for name, dropless in CASES:
        cfg, jcfg, jp = models[name]
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        fn = jax.jit(jax.value_and_grad(
            lambda p, b, d=dropless: jloss(p, jcfg, b, _jrt(d)),
            has_aux=True))
        (loss, metrics), grads = fn(jp, batch)
        out[name, dropless] = (float(loss), _np(metrics), _np(grads))
    return out


def _port_params(models, name):
    cfg, _, jp = models[name]
    return params_from_numpy(cfg, _np(jp), device="cpu")


def _assert_grads_close(got, want, rtol=GRAD_RTOL):
    """Per leaf: max|got - want| <= rtol * max|want|."""
    want = dict(tree_items(want))
    got = dict(tree_items(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = np.asarray(got[path], np.float32)
        d = float(np.max(np.abs(g - w)))
        assert d <= rtol * float(np.max(np.abs(w))), (path, d)


# ===========================================================================
# Loss and gradients
# ===========================================================================
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    tl = torch.from_numpy(logits).to(dtype)
    want = float(jce(jnp.asarray(tl.float().numpy()), jnp.asarray(labels)))
    got = cross_entropy(tl, torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name,dropless", CASES)
def test_loss_and_grads_match_jax_grad(models, jax_grads, name, dropless,
                                       policy):
    cfg = models[name][0]
    jl, jm, jg = jax_grads[name, dropless]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, metrics, grads = value_and_grad(
        cfg, _rt(dropless, policy), _port_params(models, name), batch)
    assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl)
    assert abs(float(metrics["ce"]) - float(jm["ce"])) \
        <= LOSS_RTOL * abs(float(jm["ce"]))
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= 1e-7
    if cfg.moe is not None:
        assert float(metrics["aux"]) > 0
    _assert_grads_close(grads, jg)


def test_sort_once_moe_layer_carries_gradients(models):
    """Under ``cuda`` the dropless layer's one-sort grouped GEMMs run
    inside the kernel-forward / reference-backward function, and its
    gradients equal the ``torch`` policy's three dispatches'."""
    cfg = models["qwen2-moe-a2.7b"][0]
    p0 = tree_map(lambda t: t[0], _port_params(models, "qwen2-moe-a2.7b")
                  ["blocks"]["moe"])
    x0 = torch.randn(2, 9, cfg.d_model,
                     generator=torch.Generator().manual_seed(0))
    grads = {}
    for pol in ("torch", "cuda"):
        p = tree_map(lambda t: t.clone().requires_grad_(), p0)
        x = x0.clone().requires_grad_()
        y, aux = tmoe.moe_ffn(p, x, cfg, dropless=True,
                              policy=POLICIES[pol])
        if pol == "cuda":
            fns = []
            stack = [y.grad_fn]
            while stack:
                fn = stack.pop()
                if fn is not None:
                    fns.append(type(fn).__name__)
                    stack.extend(f for f, _ in fn.next_functions)
            assert "_RefBackwardBackward" in fns
        ((y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum()
         + aux).backward()
        grads[pol] = {"x": x.grad, **{k: v.grad for k, v in p.items()}}
    for k, g in grads["torch"].items():
        torch.testing.assert_close(grads["cuda"][k], g, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["minicpm-2b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b"])
def test_remat_modes_give_equal_grads(models, name):
    cfg = models[name][0]
    params = _port_params(models, name)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}
    base = None
    for remat in ("none", "dots", "full"):
        rt = _rt(dropless=cfg.moe is not None, policy="cuda", remat=remat)
        loss, _, grads = value_and_grad(cfg, rt, params, batch)
        if base is None:
            base = (loss, grads)
            continue
        assert torch.equal(loss, base[0]), remat
        for (path, g), (_, g0) in zip(tree_items(grads),
                                      tree_items(base[1])):
            assert torch.equal(g, g0), (remat, path)
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(cfg, _rt(remat="some"), params, batch)


# ===========================================================================
# Optimizer and train step
# ===========================================================================
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_matches_reference(schedule):
    kw = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100,
              schedule=schedule, min_lr_frac=0.1)
    ours, ref = AdamWConfig(**kw), JAdamW(**kw)
    for step in (0, 3, 9, 10, 11, 50, 89, 90, 91, 95, 99, 100, 130):
        want = float(jlr_at(ref, jnp.asarray(step, jnp.int32)))
        got = lr_at(ours, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * want, (step, got, want)
        assert float(lr_at(ours, step)) == float(got)


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(3)

    def tree(scale=1.0):
        return {"a": (rng.standard_normal((4, 5)) * scale).astype(
                    np.float32),
                "b": {"c": (rng.standard_normal(7) * scale).astype(
                    np.float32)}}

    params, grads = tree(), tree(3.0)               # clipped: norm > 1
    mu, nu = tree(0.1), tree(0.01)
    nu = {"a": np.abs(nu["a"]), "b": {"c": np.abs(nu["b"]["c"])}}
    cfg = dict(peak_lr=1e-2, warmup_steps=4, total_steps=20,
               schedule="wsd")
    jstate = {"mu": mu, "nu": nu, "step": jnp.asarray(5, jnp.int32)}
    jp, js, jm = jadamw(JAdamW(**cfg), jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, grads),
                        jax.tree.map(jnp.asarray, jstate))
    state = {"mu": _t(mu), "nu": _t(nu),
             "step": torch.tensor(5, dtype=torch.int32)}
    tp = _t(params)
    p, s, m = adamw_update(AdamWConfig(**cfg), tp, _t(grads), state)
    assert p is tp and s is state                   # written in place
    assert int(s["step"]) == 6 and s["step"].dtype == torch.int32
    for got, want in ((p, jp), (s["mu"], js["mu"]), (s["nu"], js["nu"])):
        for (_, g), w in zip(tree_items(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=1e-6)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    assert float(m["grad_norm"]) > 1.0


def test_adamw_update_in_slices_equals_one_pass(monkeypatch):
    """A leaf past ``UPDATE_SLICE`` elements is updated in slices of its
    first axis: parameters, moments and step equal the one-pass update's
    bit for bit (the update is elementwise)."""
    from repro_torch.train import optim
    g = torch.Generator().manual_seed(3)
    cfg = AdamWConfig(warmup_steps=2, total_steps=10)

    def tree():
        return {"w": torch.randn(7, 5, 3, generator=g),
                "b": torch.randn(11, generator=g)}

    params, grads = tree(), tree()
    outs = []
    for cap in (optim.UPDATE_SLICE, 8):
        monkeypatch.setattr(optim, "UPDATE_SLICE", cap)
        p = {k: v.clone() for k, v in params.items()}
        st = optim.adamw_init(p)
        for _ in range(3):
            p, st, _ = adamw_update(cfg, p, grads, st)
        outs.append((p, st))
    (p1, s1), (p2, s2) = outs
    for k in params:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1["mu"][k], s2["mu"][k])
        assert torch.equal(s1["nu"][k], s2["nu"][k])
    assert int(s1["step"]) == int(s2["step"]) == 3


def test_train_step_matches_reference(models):
    cfg, jcfg, jp = models["minicpm-2b"]
    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10,
               schedule="wsd")
    data = JData(S, 4, cfg.vocab_size, seed=2)
    jbatch = jax.tree.map(jnp.asarray, data.batch_at(0))
    jstep = jax.jit(jmake_step(jcfg, _jrt(), JTrain(opt=JAdamW(**opt))))
    jstate, jm = jstep(jinit_state(jp), jbatch)
    state = init_state(_port_params(models, "minicpm-2b"))
    step = make_train_step(cfg, _rt(policy="cuda"),
                           TrainConfig(opt=AdamWConfig(**opt)))
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in data.batch_at(0).items()})
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    # Adam's first step moves a weight by lr * g / (|g| + eps): where |g|
    # is within a few eps of 0, a gradient difference of one f32 ulp
    # moves the update by up to ulp / eps of a step. So every weight is
    # held to a tenth of a step, and all but 1e-3 of them to 1e-6.
    lr0 = float(jm["lr"])
    for (path, g), w in zip(tree_items(state["params"]),
                            jax.tree.leaves(jstate["params"])):
        d = np.abs(g.numpy() - np.asarray(w))
        assert d.max() <= 0.1 * lr0, (path, d.max())
        assert np.mean(d > 1e-6) <= 1e-3, (path, np.mean(d > 1e-6))
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 1


def test_microbatches_take_the_same_step(models):
    """M=1 and M=2 take (numerically) the same step (the reference's
    bar, ``tests/test_substrate.py``)."""
    cfg = models["minicpm-2b"][0]
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMData(S, 8, cfg.vocab_size).batch_at(0).items()}
    outs = []
    for m in (1, 2):
        state = init_state(tree_map(torch.clone,
                                    _port_params(models, "minicpm-2b")))
        step = make_train_step(cfg, _rt(), TrainConfig(microbatches=m))
        state, metrics = step(state, batch)
        outs.append((state["params"], float(metrics["loss"])))
    assert abs(outs[0][1] - outs[1][1]) <= LOSS_RTOL * outs[0][1]
    diffs = [float((a - b).abs().max()) for (_, a), (_, b) in
             zip(tree_items(outs[0][0]), tree_items(outs[1][0]))]
    assert max(diffs) < 5e-4, max(diffs)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        make_train_step(cfg, _rt(), TrainConfig(), recipe="is")


def test_training_loss_decreases():
    """The reference's convergence check (``tests/test_substrate.py``):
    80 steps on the learnable data cut the loss by 20 %."""
    cfg = smoke_config(ARCHS["minicpm-2b"])
    data = SyntheticLMData(32, 8, cfg.vocab_size, mode="lcg")
    tc = TrainConfig(opt=AdamWConfig(peak_lr=1e-2, warmup_steps=5,
                                     total_steps=80, schedule="wsd"),
                     max_steps=80, log_every=0)
    rt = ModelRuntime(dtype="float32", remat="none", attn_chunk=16,
                      device="cpu")
    state = train_loop(cfg, rt, tc, init_state(init_params(
        cfg, seed=0, device="cpu")), iter(data), log=lambda *_: None)
    losses = state["_losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert len(losses) == 80 and last < 0.8 * first, (first, last)


# ===========================================================================
# Data
# ===========================================================================
@pytest.mark.parametrize("mode", ["lcg", "random"])
@pytest.mark.parametrize("frontend", ["token", "patch", "frame"])
def test_synthetic_data_equals_reference(mode, frontend):
    kw = dict(seq_len=12, global_batch=4, vocab_size=97, seed=3, mode=mode,
              n_hosts=2, host_id=1, frontend=frontend, d_model=8)
    ours, ref = SyntheticLMData(**kw), JData(**kw)
    for step in (0, 5):
        got, want = ours.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = iter(ours)
    first = next(it)
    assert all(isinstance(v, torch.Tensor) for v in first.values())
    for k, v in ref.batch_at(0).items():
        np.testing.assert_array_equal(first[k].numpy(), v)
    full = SyntheticLMData(12, 4, 97, seed=3, mode=mode).batch_at(2)
    for h in (0, 1):
        got, want = host_shard(full, h, 2), jhost_shard(full, h, 2)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="hosts"):
        SyntheticLMData(12, 5, 97, n_hosts=2)


# ===========================================================================
# Checkpoints
# ===========================================================================
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_between_packages(models, tmp_path, writer):
    """A train state (params, moments, int32 step) written by one
    package is read back by the other: the same files, names and bits."""
    cfg, _, jp = models["qwen2-moe-a2.7b"]
    jstate = jinit_state(jp)
    jstate["opt"]["mu"] = jax.tree.map(lambda a: a + 0.5,
                                       jstate["opt"]["mu"])
    jstate["opt"]["step"] = jnp.asarray(7, jnp.int32)
    tstate = _t(_np(jstate))
    other = tmp_path / "other"
    if writer == "port":
        path = tckpt.save(str(tmp_path), 7, tstate, extra={"k": 1})
        jckpt.save(str(other), 7, jstate, extra={"k": 1})
        back = _np(jckpt.restore(str(tmp_path), 7, jstate))
        assert jckpt.latest_step(str(tmp_path)) == 7
    else:
        path = jckpt.save(str(tmp_path), 7, jstate, extra={"k": 1})
        tckpt.save(str(other), 7, tstate, extra={"k": 1})
        back = tree_map(lambda t: t.numpy(),
                        tckpt.restore(str(tmp_path), 7, tstate))
        assert tckpt.latest_step(str(tmp_path)) == 7
    names = sorted(os.listdir(path))
    assert names == sorted(os.listdir(other / "step_00000007"))
    assert "opt_mu_blocks_moe_wg.npy" in names and "_COMPLETE" in names
    for (p, got), want in zip(tree_items(back), jax.tree.leaves(jstate)):
        want = np.asarray(want)
        assert got.dtype == want.dtype, p
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_bf16_leaf_round_trips(tmp_path, writer):
    """A bf16 leaf is written as the reference writes one (2-byte
    records, manifest dtype ``bfloat16``) and read back into the port bit
    for bit, by ``restore`` and by ``load_checkpoint`` (as the f32 array
    of the same values): the port's own leaf, and one the reference
    wrote."""
    import json

    from repro_torch.models import load_checkpoint
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16)
    tree = {"w": want, "n": {"i": torch.arange(4, dtype=torch.int32)}}
    if writer == "port":
        path = tckpt.save(str(tmp_path), 2, tree)
        ac = tckpt.AsyncCheckpointer(str(tmp_path / "async"))
        ac.submit(2, tree)
        ac.close()
        back = tckpt.restore(str(tmp_path / "async"), 2, tree)
        assert torch.equal(back["w"], want)
    else:
        path = jckpt.save(str(tmp_path), 2, {
            "w": jnp.asarray(x).astype(jnp.bfloat16),
            "n": {"i": jnp.arange(4, dtype=jnp.int32)}})
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["w"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(path, "w.npy")).dtype.itemsize == 2
    back = tckpt.restore(str(tmp_path), 2, tree)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], want)
    assert torch.equal(back["n"]["i"], tree["n"]["i"])
    loaded = load_checkpoint(path)
    assert loaded["w"].dtype == np.float32
    np.testing.assert_array_equal(loaded["w"], want.float().numpy())


def test_checkpoint_incomplete_ignored(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None
    tckpt.save(d, 1, {"w": torch.ones(4)})
    os.makedirs(os.path.join(d, "step_00000002"))     # a torn write
    assert tckpt.latest_step(d) == 1
    with pytest.raises(FileNotFoundError, match="_COMPLETE"):
        tckpt.restore(d, 2, {"w": torch.ones(4)})
    back = tckpt.restore(d, 1, {"w": torch.zeros(4)})
    assert torch.equal(back["w"], torch.ones(4))


def test_async_writer_copies_and_collects(tmp_path):
    d = str(tmp_path)
    w = torch.arange(8.0)
    ac = tckpt.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3, 4):
        ac.submit(s, {"w": w})
        w += 1                  # the train step updates in place
    ac.close()
    assert tckpt.latest_step(d) == 4
    assert sorted(n for n in os.listdir(d) if n.startswith("step")) \
        == ["step_00000003", "step_00000004"]
    back = tckpt.restore(d, 4, {"w": w})
    assert torch.equal(back["w"], torch.arange(8.0) + 3)


# ===========================================================================
# Fault hooks
# ===========================================================================
def test_step_monitor_flags_straggler():
    t = [0.0]
    events = []
    mon = StepMonitor(straggler_factor=3.0, on_straggler=events.append,
                      clock=lambda: t[0])
    for i in range(8):
        mon.step_started(i)
        t[0] += 1.0
        mon.step_finished(i)
    mon.step_started(8)
    t[0] += 10.0                       # wedged step
    mon.step_finished(8)
    assert len(events) == 1 and events[0].step == 8
    assert events[0].median == 1.0 and mon.median == 1.0


def test_watchdog_fires_and_feed_defers():
    fired = []
    wd = Watchdog(0.15, lambda: fired.append(1)).start()
    try:
        for _ in range(3):
            time.sleep(0.05)
            wd.feed()
        assert not fired
        time.sleep(0.4)
        assert fired
    finally:
        wd.stop()


# ===========================================================================
# Launcher
# ===========================================================================
def test_train_launcher_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minicpm-2b", "--smoke", "--device", "cpu", "--steps", "10"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=minicpm-2b params=0.1M devices=1 "
                               "schedule=wsd"), lines[0]
    assert sum(ln.startswith("step ") for ln in lines) == 10
    assert lines[-1].startswith("done: loss ") and "(10 steps" in lines[-1]


def test_train_launcher_restarts_from_checkpoint(capsys):
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                "--steps", "4", "--batch", "2", "--seq", "16",
                "--ckpt-dir", d, "--ckpt-every", "2"]
        launcher.main(argv)
        assert tckpt.latest_step(d) == 4
        launcher.main(argv)
    out = capsys.readouterr().out
    assert "restoring from step 4" in out
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        launcher.main(argv[:5] + ["--recipe", "is"])


def test_ssd_scan_gradient_is_finite_past_exp_range():
    """A chunk whose decay spans more than exp's f32 range (dt 2, A -1,
    chunk 64: up to 126): the reference's segment sum takes exp before
    masking, so its dt and A gradients are NaN (0 * inf); the port masks
    first. The outputs agree, and so does every gradient the reference
    gets right."""
    from repro.models.ssm import ssd_chunked as jssd

    from repro_torch.kernels.ssd_scan import ssd_chunked
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 2, 16)).astype(np.float32)
    dt = np.full((1, 64, 2), 2.0, np.float32)
    A = -np.ones(2, np.float32)
    Bm, Cm = (rng.standard_normal((1, 64, 2, 8)).astype(np.float32)
              for _ in range(2))
    args = (x, dt, A, Bm, Cm)
    jy = jssd(*map(jnp.asarray, args), 64)[0]
    jg = jax.grad(lambda *a: jssd(*a, 64)[0].sum(), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y = ssd_chunked(*ts, 64)[0]
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-4, rtol=1e-4)
    assert [bool(np.isnan(np.asarray(g)).any()) for g in jg] \
        == [False, True, True, False, False]
    for t, g in zip(ts, jg):
        assert bool(torch.isfinite(t.grad).all())
        if not np.isnan(np.asarray(g)).any():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       atol=1e-4, rtol=1e-4)
