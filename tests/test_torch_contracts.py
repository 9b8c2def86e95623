"""The port's contract checker against the reference's, on the CPU.

* the reference's three fixtures (cache axes, axis resolvability,
  dispatch closure), fed as the same seeded dicts to the reference's
  ``check_*`` and the port's, give the same ``(rule_id, symbol,
  message)`` lists (the op's reference impl is ``torch`` here where it is
  ``xla`` there: the dispatch messages are compared with that one word
  swapped);
* the live pass is clean on the port, and a seeded removal of one
  ``CACHE_AXES`` entry, or of a tune grid row, fires its rule;
* ``contract-axis-unresolvable`` is among the live pass's rules, as in
  the reference (the recipes are ``dist.sharding.RECIPES``).
"""
import types

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import contracts as jcontracts  # noqa: E402

from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis.registry import (PRESETS,  # noqa: E402
                                           AnalysisContext, all_passes)
from repro_torch.analysis.runner import run_analysis  # noqa: E402
from repro_torch.kernels import tune  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def triples(findings, swap=None):
    out = [(f.rule_id, f.location.symbol, f.message) for f in findings]
    if swap:
        out = [(r, s, m.replace(*swap)) for r, s, m in out]
    return out


def test_cache_axes_fixture_matches_reference():
    spec = {"k": ((2, 4, 8), "bfloat16"), "extra": ((2,), "int32")}
    axes = {"k": (None, "batch")}              # wrong rank; extra missing
    got = contracts.check_cache_axes(spec, axes, axes_name="CACHE_AXES",
                                     symbol="t")
    want = jcontracts.check_cache_axes(spec, axes, axes_name="CACHE_AXES",
                                       symbol="t")
    assert triples(got) == triples(want)
    assert [f.rule_id for f in got] == ["contract-cache-axes"] * 2


def test_axis_resolvable_fixture_matches_reference():
    recipes = {"WS": types.SimpleNamespace(rules={"batch": None}),
               "TP": types.SimpleNamespace(rules={"batch": None,
                                                  "kv_seq": None})}
    names = {"k": ("batch", "kv_seq"), "v": (None, "heads")}
    got = contracts.check_axis_resolvable(names, recipes, source="t")
    want = jcontracts.check_axis_resolvable(names, recipes, source="t")
    assert triples(got) == triples(want)
    assert [f.rule_id for f in got] == ["contract-axis-unresolvable"] * 2
    assert "kv_seq" in got[1].message and "'WS'" in got[1].message


@pytest.mark.parametrize("impls", [("pallas",), ("pallas", "cuda")])
def test_dispatch_closure_fixture_matches_reference(impls):
    """The reference's fixture (kernel impls and no reference impl),
    against both packages' tune presets."""
    table = {"mystery_op": {i: (lambda: None) for i in impls}}
    for presets in (tune.TUNE_PRESETS, jcontracts_presets()):
        got = contracts.check_dispatch_closure(("mystery_op",), table,
                                               presets, calib_kinds={})
        want = jcontracts.check_dispatch_closure(("mystery_op",), table,
                                                 presets, calib_kinds={})
        assert triples(got) == triples(want, swap=("'xla'", "'torch'"))
        assert sorted({f.rule_id for f in got}) == [
            "contract-calib-kind", "contract-dispatch-ref",
            "contract-tune-grid"]


def test_dispatch_closure_takes_torch_as_the_reference():
    table = {"mystery_op": {"torch": None, "cuda": None}}
    got = contracts.check_dispatch_closure(("mystery_op",), table,
                                           tune.TUNE_PRESETS,
                                           calib_kinds={"mystery_op": "x"})
    assert sorted(f.location.symbol for f in got) == [
        "mystery_op/cuda", "mystery_op/cuda", "mystery_op/torch",
        "mystery_op/torch"]
    assert {f.rule_id for f in got} == {"contract-tune-grid"}


def jcontracts_presets():
    from repro.kernels.tune import TUNE_PRESETS
    return TUNE_PRESETS


def _ctx():
    return AnalysisContext(preset=PRESETS["ci"], root=".")


def test_live_pass_is_clean():
    assert contracts.run_pass(_ctx()) == []
    rep = run_analysis("ci", rules=["contract-cache-axes",
                                    "contract-dispatch-ref",
                                    "contract-tune-grid",
                                    "contract-calib-kind"])
    assert set(rep.passes) == {"contracts"} and rep.findings == []


def test_live_pass_declares_no_recipe_rule():
    """The live pass declares the recipe rule now that the port has its
    recipes (``dist.sharding.RECIPES``), and the reference's five rules
    exactly; ``tests/test_torch_sharding.py`` holds it clean over them
    and fires it on a seeded unknown axis."""
    rules = all_passes()["contracts"].rules
    assert "contract-axis-unresolvable" in rules
    assert set(rules) == {"contract-cache-axes", "contract-axis-unresolvable",
                          "contract-dispatch-ref", "contract-tune-grid",
                          "contract-calib-kind"}
    assert rules == jcontracts_rules()


def jcontracts_rules():
    import repro.analysis.registry as jreg
    return jreg.all_passes()["contracts"].rules


@pytest.mark.parametrize("leaf", ["k", "ks", "conv", "ssm", "pos"])
def test_seeded_cache_axes_removal_fires(monkeypatch, leaf):
    axes = dict(M.CACHE_AXES)
    del axes[leaf]
    monkeypatch.setattr(M, "CACHE_AXES", axes)
    found = contracts.run_pass(_ctx())
    assert {f.rule_id for f in found} == {"contract-cache-axes"}
    assert all(f.location.symbol.endswith("/" + leaf) for f in found)
    assert all(f.location.symbol.startswith("cache_spec/") for f in found)


def test_seeded_paged_axes_rank_fires(monkeypatch):
    axes = dict(M.PAGED_CACHE_AXES, kp=(None, "kv_heads"))
    monkeypatch.setattr(M, "PAGED_CACHE_AXES", axes)
    found = contracts.run_pass(_ctx())
    assert [f.rule_id for f in found] == ["contract-cache-axes"] * 3
    assert "declares 2 axes" in found[0].message


def test_seeded_tune_grid_gap_fires(monkeypatch):
    grids = {op: dict(g) for op, g in tune.H100.grids.items()}
    del grids["moe_gemm"]["cuda"]
    monkeypatch.setitem(tune.TUNE_PRESETS, "h100",
                        tune.dataclasses.replace(tune.H100, grids=grids))
    found = contracts.run_pass(_ctx())
    assert triples(found) == [(
        "contract-tune-grid", "moe_gemm/cuda",
        "impl moe_gemm/cuda has no block-size grid in tune preset 'h100' — "
        "it is never swept or calibrated")]
