"""The port's pipeline-parallel dry-run (``repro_torch.launch.dryrun_pp``,
the counterpart of ``repro.launch.dryrun_pp``): one rank of a (stage,
data, model) mesh traced on ``meta`` through the GPipe train step.

* held to the reference's ``lower_pp`` at chatglm3-6b's smoke size
  (``n_stages=2, n_micro=4, mb=8, seq=64`` on (2, 8, 8)) in a
  subprocess with 128 forced host devices: the argument bytes equal
  XLA's leaf for leaf (every leaf whole but the block stack's stage
  block, f32, and the rank's tokens and labels); the temp bytes, FLOPs
  and collectives printed beside XLA's raw ``memory_analysis()`` and
  HLO collective bytes (XLA counts a scanned tick once, the trace every
  tick), not held;
* held to live CPU ranks at (stage 2, data 1, model 2) and (stage 2,
  data 2, model 1): every rank's counters (a ``collective-permute`` a
  shift, the backward's too; at data 2 the gradients' sum and the
  loss's mean over ``data``) equal its dry records, its argument bytes
  the trace's, and its loss and gradients the sequential form's on one
  device within the GPipe bars;
* the artifact's keys, ``python -m repro_torch.launch.dryrun_pp``
  writing under ``<root>/dryrun/pp/``, and the bubble fraction.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.launch import dryrun_pp as PP  # noqa: E402
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.launch.presets import CI  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import ModelRuntime  # noqa: E402

from torch_mesh_jobs import run_jobs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The reference's smoke-size call.
STAGES, MICRO, MB, SEQ = 2, 4, 8, 64

_REF = r"""
import json
import repro.launch.dryrun_pp as PP
from repro.configs import get_arch, smoke_config
PP.get_arch = lambda a: smoke_config(get_arch(a))
raw = {}
_cost, _coll = PP.cost_analysis_dict, PP.collective_bytes_from_hlo
def cost(compiled):
    m = compiled.memory_analysis()
    raw["argument_bytes"] = m.argument_size_in_bytes
    raw["temp_bytes"] = m.temp_size_in_bytes
    out = _cost(compiled)
    raw["flops"] = out.get("flops", 0.0)
    return out
def coll(text):
    raw["collectives"] = _coll(text)
    return raw["collectives"]
PP.cost_analysis_dict, PP.collective_bytes_from_hlo = cost, coll
art = PP.lower_pp("chatglm3-6b", n_stages=%d, n_micro=%d, mb=%d, seq=%d)
print("JSON" + json.dumps({"art": art, "raw": raw}))
""" % (STAGES, MICRO, MB, SEQ)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=128")
    r = subprocess.run([sys.executable, "-c", _REF], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][0]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def ours():
    return PP.lower_pp("chatglm3-6b", STAGES, MICRO, MB, SEQ, preset=CI)


#: Leaves whose per-rank bytes depart from XLA's argument bytes: none
#: (every leaf f32 as the reference's masters, whole but the stage block).
DEPARTURES = {}


def test_held_to_the_reference_lower_pp(reference, ours):
    raw, art = reference["raw"], reference["art"]
    assert raw["argument_bytes"] == 281344
    assert ours["memory"]["argument_bytes"] == raw["argument_bytes"] \
        + sum(DEPARTURES.values())
    for key in ("arch", "mode", "mesh", "n_micro", "status"):
        assert ours[key] == art[key], key
    assert set(art) - {"compile_s"} <= set(ours)
    assert ours["memory_gb_per_chip"] == art["memory_gb_per_chip"]
    recs = ours["collective_calls"]
    print(f"\n[dryrun_pp] chatglm3-6b smoke (2, 8, 8): arguments "
          f"{ours['memory']['argument_bytes']} B (XLA "
          f"{raw['argument_bytes']}), temp {ours['memory']['temp_bytes']} B"
          f" (XLA {raw['temp_bytes']}), flops {ours['flops_per_chip']:.6g} "
          f"(XLA {raw['flops']:.6g}); collective-permute "
          f"{recs.get('collective-permute/2')} a tick, the backward's too "
          f"(XLA {raw['collectives']['collective-permute']:.0f} B in "
          f"{raw['collectives']['op_counts']['collective-permute']} ops, "
          f"its scanned tick once); all-reduce "
          f"{ours['collectives']['all-reduce']:.0f} link B in "
          f"{ours['collectives']['op_counts']['all-reduce']} ops (XLA "
          f"{raw['collectives']['all-reduce']:.0f} in "
          f"{raw['collectives']['op_counts']['all-reduce']})")


def test_the_artifact_prices_every_tick(ours):
    """The forward shifts once a tick; the backward once a tick but the
    last (whose shifted output no one reads); the roofline terms are
    H100_SXM's and the bubble the schedule's."""
    ticks = MICRO + STAGES - 1
    calls = ours["collective_calls"]["collective-permute/2"]["calls"]
    assert calls == 2 * ticks - 1
    assert ours["collectives"]["op_counts"]["collective-permute"] == calls
    assert ours["bubble_fraction"] == (STAGES - 1) / ticks
    r = ours["roofline"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["step_time_bound_s"] == max(r["compute_s"], r["memory_s"],
                                         r["collective_s"]) > 0
    assert ours["memory"]["peak_bytes"] >= ours["memory"]["argument_bytes"]
    assert ours["kernels"]["flash_attention"] > 0


@pytest.mark.parametrize("stages,micro", [(4, 8), (2, 4), (4, 1)])
def test_the_bubble_fraction(stages, micro):
    assert PP.bubble_fraction(stages, micro) == pytest.approx(
        (stages - 1) / (micro + stages - 1))


def test_the_entry_point_writes_under_the_pp_directory(tmp_path, monkeypatch,
                                                       capsys):
    monkeypatch.setenv("REPRO_TORCH_ARTIFACT_DIR", str(tmp_path))
    PP.main(["--preset", "ci", "--stages", "2", "--micro", "2"])
    path = tmp_path / "dryrun" / "pp" / "chatglm3-6b__pp__stage2.json"
    art = json.load(open(path))
    assert art["status"] == "OK" and art["n_micro"] == 2
    assert art["mesh"] == "(stage=2, data=8, model=8)"
    assert json.loads(capsys.readouterr().out) == art


# ===========================================================================
# Held to live CPU ranks
# ===========================================================================
#: The live stage meshes: ``model`` ranks repeating one another's work,
#: and ``data`` ranks each holding half of every microbatch's rows.
LIVE_MESHES, LIVE_AXES = [(2, 1, 2), (2, 2, 1)], ("stage", "data", "model")
LIVE_MICRO, LIVE_MB, LIVE_SEQ = 4, 2, 16


def _live_rt():
    return ModelRuntime(dtype="float32", remat="full", attn_chunk=16,
                        device="cpu")


@pytest.fixture(scope="module", params=LIVE_MESHES, ids=str)
def live(request):
    mesh = request.param
    cfg = smoke_config(get_arch("chatglm3-6b"))
    whole = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (LIVE_MICRO, LIVE_MB, LIVE_SEQ),
                          dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, tokens.shape, dtype=np.int32)
    ranks = run_mesh(run_jobs, mesh, [("pp", (
        cfg, _live_rt(), LIVE_MICRO, LIVE_MB, LIVE_SEQ, whole, tokens,
        labels))], axes=LIVE_AXES, devices="cpu", timeout=300)
    return mesh, cfg, whole, tokens, labels, [r[0] for r in ranks]


def test_records_equal_the_live_pp_ranks_counters(live):
    mesh, cfg, _, _, _, ranks = live
    for rank, got in enumerate(ranks):
        dry = PP.trace_pp_rank(cfg, mesh, LIVE_AXES, rank, LIVE_MICRO,
                               LIVE_MB, LIVE_SEQ, _live_rt())
        assert got["counts"] and got["counts"] == dry["counts"], rank
        assert got["axis_counts"] == dry["axis_counts"], rank
        assert got["argument_bytes"] == dry["memory"]["argument_bytes"]
    kinds = {k.split("/")[0] + "/" + k.split("/")[1]
             for k in ranks[0]["axis_counts"]}
    assert kinds == {"collective-permute/stage", "all-reduce/stage"} | (
        {"all-reduce/data"} if mesh[1] > 1 else set())


def test_the_pp_step_is_the_sequential_step(live):
    """Loss and every leaf's gradient on each rank (its stage's blocks)
    equal the one-device step over the same rows, within the GPipe
    bars (1e-5 of the largest); at data 2 each rank's gradients are
    the mean of both halves' and its loss the global batch's."""
    from repro_torch.train.loop import value_and_grad
    mesh, cfg, whole, tokens, labels, ranks = live
    batch = {"tokens": torch.from_numpy(tokens).reshape(-1, LIVE_SEQ),
             "labels": torch.from_numpy(labels).reshape(-1, LIVE_SEQ)}
    loss, _, grads = value_and_grad(cfg, _live_rt(), whole, batch)
    per = cfg.n_layers // mesh[0]
    want = dict(_leaves(grads))
    for r in ranks:
        s = r["rank"] // (mesh[1] * mesh[2])
        assert r["loss"] == pytest.approx(float(loss), rel=1e-5)
        got = dict(_leaves(r["grads"]))
        assert set(got) == set(want)
        for path, w in want.items():
            g = got[path]
            if path[0] == "blocks":
                w, g = w[s * per:(s + 1) * per], g[0]
            d = float((g - w).abs().max())
            assert d <= 1e-5 * float(w.abs().max()), (path, d)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree
