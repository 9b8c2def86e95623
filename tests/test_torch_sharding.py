"""The port's sharding against the reference's, on the host: no process
group, meshes as dicts of axis sizes (the reference's ``_ProxyMesh``).

* ``models.model.axes_tree`` equals ``repro.models.model.axes_tree`` leaf
  for leaf, for all ten archs;
* ``dist.sharding``'s recipes, ``sanitize_spec`` specs and ``SpecDrop``
  records equal the reference's for every parameter and cache leaf of
  every arch under every recipe at meshes (1, 2), (2, 2), (2, 4) and
  (1, 8);
* the port's placement: a query head never straddles ranks, each rank
  holds exactly the K/V heads its query heads read, and every family's
  blocks (the MoE, SSM, hybrid and audio ones too) tile each leaf;
* ``capacity``/``serve_preflight``/``deploy_preflight`` bytes at those
  meshes equal the reference's except on the pinned leaves: those with
  an attention-heads axis, where the port's head plan departs from the
  reference's spec division, the Mamba-2 mixer's (head-aligned, B/C
  whole) and the MoE router (whole), each such leaf's bytes worked out
  here;
* the contract checker over the live recipes is clean, and a seeded
  unknown axis fires ``contract-axis-unresolvable``.
"""
import importlib
import math

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import scenarios as jscen  # noqa: E402

from repro_torch.analysis.contracts import (  # noqa: E402
    check_axis_resolvable, param_axis_names)
from repro_torch.analysis.deploy_lint import (DeploymentSpec,  # noqa: E402
                                              deploy_preflight)
from repro_torch.analysis.registry import (PRESETS,  # noqa: E402
                                           all_passes,
                                           AnalysisContext)
from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import scenarios as scen  # noqa: E402

cap = importlib.import_module("repro_torch.analysis.capacity")
jcap = importlib.import_module("repro.analysis.capacity")
jdeploy = importlib.import_module("repro.analysis.deploy_lint")
contracts = importlib.import_module("repro_torch.analysis.contracts")

ARCH_IDS = tuple(ARCHS)
DECODERS = tuple(a for a in ARCH_IDS if not ARCHS[a].is_encoder_only)
MESHES = ((1, 2), (2, 2), (2, 4), (1, 8))
HEAD_AXES = ("heads", "kv_heads")
SSM_AXES = ("ssm_heads", "ssm_inner")


def _sizes(mesh):
    return {"data": mesh[0], "model": mesh[1]}


def _cfgs(arch):
    return smoke_config(get_arch(arch)), jsmoke(jget_arch(arch))


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}['{k}']")
    else:
        yield path, tree


def _drop_fields(d):
    return (d.path, d.axis, tuple(d.spec), d.dim, tuple(d.shape),
            tuple(d.mesh_sizes), d.reason)


# ===========================================================================
# Logical axes
# ===========================================================================
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_tree_matches_reference(arch):
    cfg, jcfg = _cfgs(arch)
    for c, jc in ((cfg, jcfg), (get_arch(arch), jget_arch(arch))):
        ours, ref = tmodel.axes_tree(c), jmodel.axes_tree(jc)
        assert dict(_walk(ours)) == {p: tuple(a) for p, a in _walk(ref)}
        # every leaf's axes match its shape's rank
        shapes = dict(_walk(tmodel.param_defs(c)))
        for path, axes in _walk(ours):
            assert len(axes) == len(shapes[path].shape), path


def test_recipes_match_reference():
    assert set(sh.RECIPES) == set(jsh.RECIPES)
    for name, recipe in sh.RECIPES.items():
        assert recipe.name == jsh.RECIPES[name].name
        assert recipe.rules == jsh.RECIPES[name].rules
    assert sh.DECODE_RECIPE.rules == jsh.DECODE_RECIPE.rules


# ===========================================================================
# Specs and drops
# ===========================================================================
def _trees(arch):
    """(name, port tree of shapes, port axes, reference tree, reference
    axes) for the parameters, the contiguous cache and the paged cache
    of an arch at smoke size."""
    cfg, jcfg = _cfgs(arch)
    out = [("params", tmodel.param_defs(cfg), tmodel.axes_tree(cfg),
            jmodel.abstract_params(jcfg), jmodel.axes_tree(jcfg))]
    if not cfg.is_encoder_only:
        cs = tmodel.cache_spec(cfg, 4, 64)
        jcs = jmodel.cache_spec(jcfg, 4, 64)
        ps = tmodel.paged_cache_spec(cfg, 4, 17, 8, 64)
        jps = jmodel.paged_cache_spec(jcfg, 4, 17, 8, 64)
        out.append(("cache", cs, tmodel.CACHE_AXES, jcs, jmodel.CACHE_AXES))
        out.append(("paged", ps, tmodel.PAGED_CACHE_AXES, jps,
                    jmodel.PAGED_CACHE_AXES))
    return out


def _ref_specs(tree, axes, recipe, proxy):
    """The reference's ``param_sharding_tree`` body, spec by spec (its
    ``NamedSharding`` needs real devices)."""
    if isinstance(next(iter(tree.values())), tuple):       # a cache spec
        tree = {k: jax.ShapeDtypeStruct(s, d) for k, (s, d) in tree.items()}
        axes = {k: axes[k] for k in tree}
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    ax = jax.tree.flatten(axes, is_leaf=jsh._is_axes_leaf)[0]
    out = {}
    for (path, leaf), a in zip(leaves, ax):
        a = a or (None,) * len(leaf.shape)
        out[jax.tree_util.keystr(path)] = tuple(jsh.sanitize_spec(
            recipe.spec_for(a), leaf.shape, proxy,
            path=jax.tree_util.keystr(path)))
    return out


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_drops_match_reference(arch, mesh):
    sizes = _sizes(mesh)
    proxy = jcap._ProxyMesh(sizes)
    for name, tree, axes, jtree, jaxes in _trees(arch):
        if name != "params":
            tree = {k: _Shape(s) for k, (s, _) in tree.items()}
            axes = {k: axes[k] for k in tree}
        for rname, recipe in sh.RECIPES.items():
            sh.reset_spec_drops()
            jsh.reset_spec_drops()
            ours = dict(_walk(sh.param_sharding_tree(axes, recipe, sizes,
                                                     tree)))
            ref = _ref_specs(jtree, jaxes, jsh.RECIPES[rname], proxy)
            assert ours == ref, (name, rname)
            assert [_drop_fields(d) for d in sh.spec_drops()] == \
                [_drop_fields(d) for d in jsh.spec_drops()], (name, rname)
            assert sh.spec_drop_count() == jsh.spec_drop_count()
            for reason in ("missing-axis", "axis-reused", "indivisible"):
                assert sh.spec_drop_count(reason) == \
                    jsh.spec_drop_count(reason)


def test_sanitize_spec_degrades_and_records():
    sh.reset_spec_drops()
    sizes = {"data": 2, "model": 4}
    assert sh.sanitize_spec((("pod", "data"), "model"), (6, 8), sizes,
                            path="x") == ("data", "model")
    assert sh.sanitize_spec(("model", "model"), (8, 8), sizes) == ("model",)
    assert sh.sanitize_spec(("model",), (6,), sizes) == ()
    assert [d.reason for d in sh.spec_drops()] == [
        "missing-axis", "axis-reused", "indivisible"]
    assert sh.spec_drops()[0].path == "x"


# ===========================================================================
# The port's placement
# ===========================================================================
def _expected_heads(cfg, model):
    """(query heads, K/V heads) a rank holds: the query heads split when
    they divide and each rank's fall under whole K/V heads."""
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    if model > 1 and nq % model == 0 and (nkv % model == 0
                                          or model % nkv == 0):
        return nq // model, max(1, nkv // model)
    return nq, nkv


@pytest.mark.parametrize("arch,model,want", [
    ("minicpm-2b", 2, (18, 18)), ("chatglm3-6b", 4, (8, 1)),
    ("starcoder2-3b", 4, (6, 1)), ("stablelm-12b", 8, (4, 1)),
    ("qwen2-vl-7b", 8, (28, 4)), ("qwen2-vl-7b", 4, (7, 1))])
def test_head_plan_at_full_width(arch, model, want):
    cfg = get_arch(arch)
    pl = sh.Placement(cfg, sh.DECODE_RECIPE, {"data": 1, "model": model})
    assert (pl.q_heads, pl.kv_heads) == want == _expected_heads(cfg, model)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_blocks_tile_every_leaf(mesh):
    """Every rank's blocks (smoke minicpm-2b: 4 query heads over 2 K/V
    heads): the query-head columns of ``wq`` tile it in rank order, each
    rank's ``wk`` columns are the K/V head its query heads read, the
    vocabulary rows tile the embedding, and ``shard_tree`` copies rank
    0's blocks."""
    cfg = smoke_config(get_arch("minicpm-2b"))
    sizes = _sizes(mesh)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    axes = dict(_walk(tmodel.axes_tree(cfg)))
    hd, G = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    ranks = [sh.Placement(cfg, sh.DECODE_RECIPE, sizes,
                          coords={"data": 0, "model": m})
             for m in range(mesh[1])]

    def block(pl, path, leaf):
        return leaf[pl.slices(axes[path], tuple(leaf.shape))]

    got = dict(_walk(sh.shard_tree(params, tmodel.axes_tree(cfg),
                                   sh.DECODE_RECIPE, sizes, cfg)))
    for path, leaf in _walk(params):
        assert torch.equal(got[path], block(ranks[0], path, leaf)), path
    wq, wk = params["blocks"]["wq"], params["blocks"]["wk"]
    emb = params["embed"]
    if ranks[0].heads_split:
        torch.testing.assert_close(torch.cat(
            [block(pl, "['blocks']['wq']", wq) for pl in ranks], -1), wq)
        for m, pl in enumerate(ranks):
            assert pl.q_start == m * pl.q_heads
            kv = pl.q_start // G
            assert pl.kv_start == kv
            assert pl.kv_start + pl.kv_heads - 1 == \
                (pl.q_start + pl.q_heads - 1) // G
            torch.testing.assert_close(
                block(pl, "['blocks']['wk']", wk)[..., :hd],
                wk[..., kv * hd:(kv + 1) * hd])
    else:
        assert block(ranks[-1], "['blocks']['wq']", wq).shape == wq.shape
    if ranks[0].vocab_split:
        torch.testing.assert_close(torch.cat(
            [block(pl, "['embed']", emb) for pl in ranks], 0), emb)
        assert [pl.vocab_start for pl in ranks] == \
            [m * cfg.vocab_size // mesh[1] for m in range(mesh[1])]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b",
                                  "zamba2-2.7b", "hubert-xlarge"])
def test_every_family_tiles_its_leaves_on_a_mesh(arch):
    """Every rank's blocks of every leaf (the placement at its
    coordinates) put back at their slices rebuild the whole tree, and
    every element is held: the MoE's experts, the Mamba-2 mixer's
    head-aligned columns and channels (a list of indices a dim), the
    hybrid's shared blocks, hubert's vocabulary, under the decode and
    IS recipes at (2, 2) and (1, 4)."""
    cfg = smoke_config(get_arch(arch))
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    axes = dict(_walk(tmodel.axes_tree(cfg)))
    for mesh, recipe in (((2, 2), sh.IS_RECIPE), ((1, 4), sh.DECODE_RECIPE)):
        sizes = _sizes(mesh)
        whole = {p: torch.zeros_like(t) for p, t in _walk(params)}
        held = {p: torch.zeros(t.shape, dtype=torch.bool)
                for p, t in _walk(params)}
        for d in range(mesh[0]):
            for m in range(mesh[1]):
                pl = sh.Placement(cfg, recipe, sizes,
                                  coords={"data": d, "model": m})
                for path, block in _blocks(params, axes, pl).items():
                    idx = pl.slices(axes[path], tuple(whole[path].shape),
                                    record=False)
                    whole[path][idx] = block
                    held[path][idx] = True
        for path, leaf in _walk(params):
            assert bool(held[path].all()), (mesh, path)
            assert torch.equal(whole[path], leaf), (mesh, path)


def _blocks(params, axes, pl):
    """{path: this rank's block} of ``params`` under ``pl``."""
    return {path: leaf[pl.slices(axes[path], tuple(leaf.shape),
                                 record=False)]
            for path, leaf in _walk(params)}


# ===========================================================================
# Capacity, preflight and deploy bytes
# ===========================================================================
def _leaf_bytes(tree, axes, recipe, sizes, cfg, item):
    """{path: (port bytes, reference bytes)} of every leaf; ``item(path,
    leaf)`` its element size."""
    pl = sh.Placement(cfg, recipe, sizes)
    flat_axes = dict(_walk(axes))
    out = {}
    for path, leaf in _walk(tree):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else tuple(leaf[0])
        a = flat_axes[path] or (None,) * len(shape)
        n = item(path, leaf)
        out[path] = (math.prod(pl.local_shape(a, shape)) * n,
                     jcap.sharded_bytes(shape, n, recipe.spec_for(a),
                                        sizes), a, shape)
    return out


def _ssm_extent(cfg, model, name, dim):
    """A Mamba-2 dim's extent on a rank: head-aligned (each rank its
    nh / M heads' z, x and dt, B and C of the one group whole) when the
    heads divide over ``model``, else whole."""
    s = cfg.ssm
    di, nh, N = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.d_state
    assert s.n_groups == 1
    if model == 1 or nh % model:
        return dim
    if name == "ssm_heads":
        return nh // model
    return {di: di // model, di + 2 * N: di // model + 2 * N,
            2 * di + 2 * N + nh: 2 * di // model + 2 * N + nh // model}[dim]


def _pinned_delta(tree, axes, recipe, sizes, cfg, item):
    """Port minus reference bytes over the pinned leaves (those with a
    heads axis or a Mamba-2 axis, and the MoE router), each checked
    against the plan worked out here; every other leaf must agree."""
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    q, kv = _expected_heads(cfg, sizes["model"])
    delta = 0
    for path, (ours, ref, a, shape) in _leaf_bytes(
            tree, axes, recipe, sizes, cfg, item).items():
        router = "experts" in a and "expert_ffn" not in a
        if not (set(a) & set(HEAD_AXES + SSM_AXES) or router):
            assert ours == ref, path
            continue
        # the head dims by the head plan, the mixer's by its heads, the
        # router's experts whole, every other dim as the reference's
        # sanitized spec divides it
        spec = tuple(jsh.sanitize_spec(recipe.spec_for(a), shape,
                                       jcap._ProxyMesh(sizes)))
        spec += (None,) * (len(shape) - len(spec))
        want = math.prod(shape) * item(path, None)
        for name, entry, dim in zip(a, spec, shape):
            if name == "heads":
                want = want // nq * q
            elif name == "kv_heads":
                want = want // nkv * kv
            elif name in SSM_AXES:
                want = want // dim * _ssm_extent(cfg, sizes["model"], name,
                                                 dim)
            elif router and name == "experts":
                continue
            else:
                for ax in ((entry,) if isinstance(entry, str)
                           else entry or ()):
                    want //= sizes[ax]
        assert ours == want, (path, ours, want)
        delta += ours - ref
    return delta


def _param_item(dtype):
    def item(path, leaf):
        keep = any(f"['{k}']" in path for k in tmodel.F32_LEAVES)
        return 4 if keep or dtype == "float32" else 2
    return item


def _cache_item(spec):
    return lambda path, leaf: torch.empty((), dtype=spec[
        path[2:-2]][1]).element_size()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", DECODERS)
def test_serving_bytes_match_reference_outside_pinned_leaves(arch, mesh):
    cfg, jcfg = _cfgs(arch)
    sizes = _sizes(mesh)
    recipe = sh.DECODE_RECIPE
    p_delta = _pinned_delta(tmodel.param_defs(cfg), tmodel.axes_tree(cfg),
                            recipe, sizes, cfg, _param_item("float32"))
    for kv in (None, "int8"):
        for paged in (False, True):
            skw = dict(n_slots=4, max_len=64)
            if paged:
                skw.update(page_budget=17, page_size=8)
                cs = tmodel.paged_cache_spec(cfg, 4, 17, 8, 64,
                                             kv_dtype=kv)
                axes = {k: tmodel.PAGED_CACHE_AXES[k] for k in cs}
            else:
                cs = tmodel.cache_spec(cfg, 4, 64, kv_dtype=kv)
                axes = {k: tmodel.CACHE_AXES[k] for k in cs}
            c_delta = _pinned_delta(cs, axes, recipe, sizes, cfg,
                                    _cache_item(cs))
            ours = cap.capacity(cfg, mesh=sizes, recipe="decode",
                                dtype="bfloat16", param_dtype="float32",
                                kv_dtype=kv, **skw)
            ref = jcap.capacity(jcfg, mesh=sizes, recipe="decode",
                                param_dtype="float32", kv_dtype=kv, **skw)
            assert ours.params_bytes == ref.params_bytes + p_delta
            assert ours.cache_bytes == ref.cache_bytes + c_delta
            assert ours.batch_bytes == ref.batch_bytes
            assert ours.argument_bytes == \
                ref.argument_bytes + p_delta + c_delta
            assert ours.mesh_sizes == ref.mesh_sizes == sizes
            assert ours.devices == ref.devices == math.prod(mesh)
            assert ours.recipe == ref.recipe == "decode"
            for k in ("act", "logits", "scores", "cache_allsh"):
                assert math.isclose(ours.features[k], ref.features[k],
                                    rel_tol=1e-12), k
        # serve_preflight prices the pool the paged engine derives, per
        # device, under the decode recipe
        pre = cap.serve_preflight(cfg, n_slots=4, max_len=64, page_size=8,
                                  mesh=sizes, dtype="bfloat16",
                                  param_dtype="float32", kv_dtype=kv)
        jpre = jcap.serve_preflight(jcfg, n_slots=4, max_len=64,
                                    page_size=8, mesh=sizes,
                                    param_dtype="float32", kv_dtype=kv)
        assert pre.params_bytes == jpre.params_bytes + p_delta
        n_pages = cap.default_page_budget(cfg, 4, 64, 8, "bfloat16", kv)
        cs = tmodel.paged_cache_spec(cfg, 4, n_pages, 8, 64, kv_dtype=kv)
        axes = {k: tmodel.PAGED_CACHE_AXES[k] for k in cs}
        assert pre.cache_bytes == jpre.cache_bytes + _pinned_delta(
            cs, axes, recipe, sizes, cfg, _cache_item(cs))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_bytes_match_reference_outside_pinned_leaves(arch, mesh):
    """Prefill and train shapes under the reference launcher's recipe."""
    cfg, jcfg = _cfgs(arch)
    sizes = _sizes(mesh)
    for kind, (B, S) in (("prefill", (2, 32)), ("train", (4, 24))):
        recipe = sh.default_recipe(cfg, kind, mesh[1])
        ours = cap.capacity(cfg, ShapeConfig(kind, S, B, kind), mesh=sizes,
                            dtype="bfloat16", param_dtype="float32")
        ref = jcap.capacity(jcfg, JShape(kind, S, B, kind), mesh=sizes,
                            param_dtype="float32")
        assert ours.recipe == ref.recipe == recipe.name
        delta = _pinned_delta(tmodel.param_defs(cfg), tmodel.axes_tree(cfg),
                              recipe, sizes, cfg, _param_item("float32"))
        extra = 0
        if kind == "prefill" and cfg.frontend != "token":
            # the port holds the token table; the reference's XLA prunes it
            pl = sh.Placement(cfg, recipe, sizes)
            extra = math.prod(pl.local_shape(
                ("vocab", "embed"), (cfg.vocab_size, cfg.d_model))) * 4
        assert ours.params_bytes == ref.params_bytes + delta + extra
        n = 3 if kind == "train" else 1
        assert ours.argument_bytes == \
            ref.argument_bytes + n * delta + extra
        assert ours.batch_bytes == ref.batch_bytes


DEPLOY = dict(n_slots=4, max_len=64, page_size=8)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", DECODERS)
def test_deploy_preflight_bytes_match_reference(arch, mesh):
    from repro.core.hardware import TPUSpec
    from repro_torch.core.hardware import H100_SXM
    h100 = TPUSpec(name=H100_SXM.name,
                   peak_flops_bf16=H100_SXM.peak_flops_bf16,
                   peak_flops_int8=H100_SXM.peak_flops_int8,
                   hbm_bytes=H100_SXM.hbm_bytes, hbm_bw=H100_SXM.hbm_bw)
    cfg, jcfg = _cfgs(arch)
    sizes = _sizes(mesh)
    for name in sorted(jscen.SCENARIOS):
        s = scen.SCENARIOS[name].scaled(64)
        js = jscen.SCENARIOS[name].scaled(64)
        ours = deploy_preflight(cfg, s, deployment=DeploymentSpec(
            mesh=sizes, **DEPLOY))
        ref = jdeploy.deploy_preflight(
            jcfg, js, deployment=jdeploy.DeploymentSpec(mesh=sizes,
                                                        **DEPLOY),
            chip=h100)
        assert math.isclose(ours.alloc_bytes, ref.alloc_bytes,
                            rel_tol=1e-12)
        assert ours.cache_tokens == ref.cache_tokens
        assert ours.mesh == ref.mesh == sizes
        # the one-card bound over the devices: a lower bound still
        one = deploy_preflight(cfg, s, deployment=DeploymentSpec(**DEPLOY))
        assert math.isclose(ours.tok_p50_lb_ms * math.prod(mesh),
                            one.tok_p50_lb_ms, rel_tol=1e-12)


# ===========================================================================
# Contracts over the live recipes
# ===========================================================================
def test_contracts_pass_clean_over_live_recipes():
    ctx = AnalysisContext(preset=PRESETS["ci"], root=".")
    findings = contracts.run_pass(ctx)
    assert findings == [], [f.message for f in findings]
    assert "contract-axis-unresolvable" in all_passes()["contracts"].rules
    for arch in ARCH_IDS:
        names = param_axis_names(get_arch(arch))
        assert check_axis_resolvable(names, sh.RECIPES,
                                     source=arch) == []


def test_seeded_unknown_axis_fires_unresolvable():
    axes = dict(tmodel.CACHE_AXES, bogus=(None, "no_such_axis"))
    found = check_axis_resolvable(axes, sh.RECIPES, source="CACHE_AXES")
    assert [f.rule_id for f in found] == ["contract-axis-unresolvable"]
    assert "no_such_axis" in found[0].message
    assert all(repr(r) in found[0].message for r in sh.RECIPES)
