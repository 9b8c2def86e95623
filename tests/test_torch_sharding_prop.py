"""The port's sharding propagation (``analysis/sharding_prop.py``) held
to the reference's pass (``repro.analysis.sharding_prop``) on the ``ci``
preset, cell for cell.

* ``shard-unknown-mesh-axis``: none on the live recipes of either
  package; the rule fires alike on a doctored recipe;
* ``shard-spec-dropped``: the same cells, counts and example leaves;
* ``shard-replicated-large``: the same leaves but the pinned departures,
  the paged ``kp``/``vp`` pools where the port gives each rank the K/V
  heads its query heads read (chatglm3-6b: 1 of 2 heads a rank,
  mixtral-8x22b and stablelm-12b: 1 of 8), each with its factor;
* no error finding; the pass runs through the runner.
"""
import math

import pytest

pytest.importorskip("torch")

from repro.analysis import sharding_prop as jprop  # noqa: E402
from repro.analysis.registry import AnalysisContext as JContext  # noqa: E402
from repro.analysis.registry import PRESETS as JPRESETS  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import get_shape as jget_shape  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.launch.presets import FULL  # noqa: E402

from repro_torch.analysis import sharding_prop as prop  # noqa: E402
from repro_torch.analysis.registry import (PRESETS,  # noqa: E402
                                           AnalysisContext)
from repro_torch.analysis.runner import run_analysis  # noqa: E402
from repro_torch.configs import get_arch, get_shape  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.sharding import Placement, default_recipe  # noqa: E402
from repro_torch.models.model import PAGED_CACHE_AXES  # noqa: E402

#: The port's departures from the reference's ``shard-replicated-large``:
#: (arch, K/V heads a rank holds of the arch's) for the paged pools of
#: the decode cells on both meshes.
DEPARTURES = {"chatglm3-6b": (1, 2), "mixtral-8x22b": (1, 8),
              "stablelm-12b": (1, 8)}
RULES = ("shard-unknown-mesh-axis", "shard-spec-dropped",
         "shard-replicated-large")


@pytest.fixture(scope="module")
def passes():
    """(the reference's findings, the port's) on ``ci``, by rule and
    cell symbol."""
    ref = jprop.run_pass(JContext(preset=JPRESETS["ci"], root="."))
    ours = prop.run_pass(AnalysisContext(preset=PRESETS["ci"], root="."))

    def by_rule(found):
        out = {r: {} for r in RULES}
        for f in found:
            assert f.location.symbol not in out[f.rule_id], f.describe()
            out[f.rule_id][f.location.symbol] = f
        return out
    return by_rule(ref), by_rule(ours), ours


def _departed():
    return {f"{arch}/{mesh}/decode/paged_cache['{leaf}']"
            for arch in DEPARTURES for mesh in prop.MESHES
            for leaf in ("kp", "vp")}


def test_mesh_axes_and_the_live_recipes():
    assert set(prop.known_mesh_axes()) == {"pod", "data", "model"} \
        == set(jprop.known_mesh_axes())
    assert prop.find_unknown_axes() == [] == jprop.find_unknown_axes()


def test_meshes_are_the_references_full_meshes():
    assert prop.MESHES == {name: FULL.mesh_spec(name).axis_sizes()
                           for name in FULL.meshes}


def test_unknown_axis_rule_on_a_doctored_recipe(monkeypatch):
    """The reference's doctored recipe in both packages: the same
    findings, each naming the recipe."""
    monkeypatch.setattr(jsharding, "RECIPES", {**jsharding.RECIPES, "bad":
                        jsharding.Recipe("bad", {"heads": ("nope",)})})
    monkeypatch.setattr(sharding, "RECIPES", {**sharding.RECIPES, "bad":
                        sharding.Recipe("bad", {"heads": ("nope",)})})
    want = [(f.rule_id, f.severity, f.location.symbol)
            for f in jprop.find_unknown_axes()]
    got = [(f.rule_id, f.severity, f.location.symbol)
           for f in prop.find_unknown_axes()]
    assert got == want == [("shard-unknown-mesh-axis", "error",
                            "recipe/bad/heads")]


def test_spec_dropped_equals_the_reference_cell_for_cell(passes):
    """The same cells, each with the same count and example leaves (the
    whole message)."""
    ref, ours, _ = passes
    want = {k: (f.severity, f.message)
            for k, f in ref["shard-spec-dropped"].items()}
    got = {k: (f.severity, f.message)
           for k, f in ours["shard-spec-dropped"].items()}
    assert got == want
    assert len(got) == 36


def test_replicated_large_equals_the_reference_but_the_departures(passes):
    """Every leaf the port holds whole the reference does too, at the
    same size and severity; the reference's others are the pinned
    departures and nothing else."""
    ref, ours, _ = passes
    ref, ours = ref["shard-replicated-large"], ours["shard-replicated-large"]
    assert set(ours) <= set(ref)
    assert set(ref) - set(ours) == _departed()
    for k, f in ours.items():
        assert f.severity == ref[k].severity == "info"
        assert f.message.split(" GiB")[0] == ref[k].message.split(" GiB")[0]
    assert len(ours) == 12


@pytest.mark.parametrize("mesh", sorted(prop.MESHES))
@pytest.mark.parametrize("arch", sorted(DEPARTURES))
def test_each_departure_holds_its_factor(arch, mesh):
    """A rank holds the K/V heads its query heads read of every paged
    pool: the reference's spec keeps them whole (``kv_heads`` does not
    divide ``model`` 16), the port's bytes are 1/2 or 1/8 of them."""
    cfg, sizes = get_arch(arch), prop.MESHES[mesh]
    shape = get_shape("decode_32k")
    recipe = default_recipe(cfg, "decode", sizes["model"])
    pl = Placement(cfg, recipe, sizes)
    held, heads = DEPARTURES[arch]
    assert cfg.n_kv_heads == heads and pl.kv_heads == held
    trees = {label: (tree, axes)
             for label, tree, axes, _ in prop.cell_trees(cfg, "decode", shape)}
    spec, axes = trees["paged_cache"]
    assert axes == {k: PAGED_CACHE_AXES[k] for k in spec}
    for leaf in ("kp", "vp"):
        whole = spec[leaf][0]
        local = pl.local_shape(axes[leaf], whole)
        assert math.prod(whole) // math.prod(local) == heads // held
        # the spec alone would keep the pool whole on every rank
        assert sharding._sanitize(recipe.spec_for(axes[leaf]), whole,
                                  sizes, None, record=False) == ()


def test_chatglm3_decode_cell():
    """The reference test's cell (2 K/V heads on ``model`` 16): the same
    indivisibility reported in both; the reference's whole paged pools
    are the port's departure (half of them a rank), so the port reports
    no leaf of the cell held whole."""
    sizes = FULL.mesh_spec("single").axis_sizes()
    ref = jprop.propagate_cell(
        jget_arch("chatglm3-6b"), "single", sizes, "decode",
        jget_shape("decode_32k"), replicated_floor=2 << 30, seen=set())
    ours = prop.propagate_cell(
        get_arch("chatglm3-6b"), "single", sizes, "decode",
        get_shape("decode_32k"), replicated_floor=2 << 30, seen=set())
    assert "shard-spec-dropped" in {f.rule_id for f in ours}
    drop = [f for f in ours if f.rule_id == "shard-spec-dropped"]
    assert [f.message for f in drop] == [
        f.message for f in ref if f.rule_id == "shard-spec-dropped"]
    rep = [f for f in ref if f.rule_id == "shard-replicated-large"]
    assert rep and all(f.severity == "info" for f in rep)
    assert [f for f in ours if f.rule_id == "shard-replicated-large"] == []


def test_no_error_finding_and_the_runner(passes):
    _, _, ours = passes
    assert [f for f in ours if f.severity == "error"] == []
    assert [f for f in ours if f.severity == "warning"] == []
    rep = run_analysis("ci", rules=["shard-spec-dropped"])
    assert set(rep.passes) == {"sharding_prop"}
    assert len(rep.findings) == 36
