"""The serve launcher's scenario, preflight and strict gates, and the two
examples, on the CPU.

``python -m repro_torch.launch.serve`` runs in-process on ``--device
cpu``: ``--scenario`` samples the requests the scenario describes,
``--preflight`` prints the deploy bounds and the capacity gate at the
runtime's f32, ``--hbm-gb`` moves the budget and ``--strict`` refuses an
error-severity deploy finding. The three refusals ``chip_smoke.py``
drives on the card run here with their full-width configs (pure shape
math): each must exit naming its rule before a parameter is drawn
(``init_params`` is replaced by a function that fails the test).
``--mesh 2x2`` serves the one-device tokens over four CPU ranks, and
refuses a family the mesh forms do not cover.
``serve_batched`` gives the same greedy tokens under both kernel
policies, paged == contiguous; ``train_100m`` resumes from its latest
checkpoint.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.capacity import serve_preflight  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.examples import serve_batched, train_100m  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.serve import get_scenario  # noqa: E402

SMOKE = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu"]


@pytest.fixture
def no_alloc(monkeypatch):
    """Fail the test if the launcher draws any parameter."""
    def refuse(*a, **k):
        raise AssertionError("a refused config reached init_params")
    monkeypatch.setattr(launcher, "init_params", refuse)


def test_scenario_requests_come_from_the_scenario(capsys):
    out = launcher.main(SMOKE + ["--scenario", "chat_burst", "--max-len",
                                 "128", "--requests", "5", "--seed", "3"])
    rows = get_scenario("chat_burst").scaled(128).sample_requests(5, seed=3)
    assert out["served"] == 5 and out["rejected"] == 0
    assert sorted((len(r.prompt), r.max_new_tokens)
                  for r in out["finished"]) == \
        sorted((p, o) for _, p, o in rows)
    # without --preflight the bounds stay quiet, and no gate runs
    text = capsys.readouterr().out
    assert "deploy[" not in text and "preflight:" not in text
    assert out["deploy"] is not None and out["preflight"] is None


@pytest.mark.parametrize("page_size", [0, 8])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_preflight_prints_and_admits(capsys, page_size, kv_dtype):
    argv = SMOKE + ["--scenario", "chat_burst", "--preflight",
                    "--max-len", "128", "--requests", "4",
                    "--page-size", str(page_size)]
    if kv_dtype:
        argv += ["--kv-dtype", kv_dtype]
    out = launcher.main(argv)
    text = capsys.readouterr().out
    assert "deploy[chat_burst]: rho=" in text and "preflight: " in text
    cap, drep = out["preflight"], out["deploy"]
    # the gate priced the f32 runtime the launcher then built
    cfg = smoke_config(get_arch("minicpm-2b"))
    assert cap == serve_preflight(cfg, n_slots=4, max_len=128,
                                  page_size=page_size or None,
                                  dtype="float32", kv_dtype=kv_dtype)
    assert cap.fits and out["served"] == 4
    assert out["stats"].prefill_compiles <= drep.compiles
    assert drep.tok_p50_lb_ms > 0


def test_capacity_overflow_refused_before_allocation(no_alloc):
    with pytest.raises(SystemExit, match=r"\[capacity-hbm-overflow\]"):
        launcher.main(["--arch", "stablelm-12b", "--device", "cpu",
                       "--slots", "64", "--max-len", "8192", "--preflight"])
    with pytest.raises(SystemExit, match=r"\[capacity-hbm-overflow\]"):
        launcher.main(["--arch", "minicpm-2b", "--device", "cpu",
                       "--preflight", "--hbm-gb", "4"])


def test_hbm_gb_moves_the_budget(no_alloc, capsys):
    with pytest.raises(SystemExit, match=r"\[capacity-hbm-overflow\]"):
        launcher.main(SMOKE + ["--preflight", "--hbm-gb", "0.0001"])
    assert "/ 0.0 GiB" in capsys.readouterr().out


def test_strict_refuses_admission_deadlock(no_alloc):
    with pytest.raises(SystemExit, match=r"\[deploy-admission-deadlock\]"):
        launcher.main(["--arch", "minicpm-2b", "--device", "cpu",
                       "--scenario", "rag_long_context", "--page-size", "16",
                       "--page-budget", "8", "--strict"])


def test_strict_serves_a_feasible_scenario():
    out = launcher.main(SMOKE + ["--scenario", "code_completion", "--strict",
                                 "--max-len", "128", "--requests", "3",
                                 "--page-size", "8"])
    assert out["served"] == 3 and out["deploy"].ok


def test_unknown_scenario_exits():
    with pytest.raises(SystemExit, match="known"):
        launcher.main(SMOKE + ["--scenario", "no_such_traffic"])


@pytest.mark.parametrize("page_size", [0, 8])
def test_mesh_serves_the_one_device_tokens(capsys, page_size):
    """``--mesh 2x2 --device cpu``: four ranks over gloo serve the tokens
    the one-device launcher serves; the preflight prices each device."""
    argv = SMOKE + ["--requests", "4", "--max-new", "6", "--max-len", "64",
                    "--page-size", str(page_size), "--preflight"]
    one = launcher.main(argv)
    out = launcher.main(argv + ["--mesh", "2x2"])
    text = capsys.readouterr().out
    assert "mesh 2x2 (data, model) over gloo" in text
    assert "per device of mesh" in text
    assert out["backend"] == "gloo" and out["mesh"] == {"data": 2,
                                                         "model": 2}
    assert {r.rid: r.out_tokens for r in out["finished"]} == \
        {r.rid: r.out_tokens for r in one["finished"]}
    cfg = smoke_config(get_arch("minicpm-2b"))
    assert out["preflight"] == serve_preflight(
        cfg, n_slots=4, max_len=64, page_size=page_size or None,
        mesh={"data": 2, "model": 2}, dtype="float32")
    assert out["preflight"].params_bytes < one["preflight"].params_bytes


def test_mesh_refusals(no_alloc):
    """An encoder has no decode step on a mesh either, and a mesh must
    read DxM: both refused before any weight is drawn."""
    with pytest.raises(SystemExit, match="encoder-only"):
        launcher.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                       "cpu", "--mesh", "1x2"])
    with pytest.raises(SystemExit, match="DxM"):
        launcher.main(SMOKE + ["--mesh", "2by2"])


def test_mesh_serves_an_ssm_model(capsys):
    """``--mesh 1x2`` takes the SSM family: mamba2's SSD heads split over
    the two ranks, the tokens the one-device launcher's."""
    argv = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--max-len", "64"]
    one = launcher.main(argv)
    out = launcher.main(argv + ["--mesh", "1x2"])
    assert "mesh 1x2 (data, model) over gloo" in capsys.readouterr().out
    assert {r.rid: r.out_tokens for r in out["finished"]} == \
        {r.rid: r.out_tokens for r in one["finished"]}


# ===========================================================================
# The examples
# ===========================================================================
def test_serve_batched_policies_and_layouts():
    runs = {name: serve_batched.main(["--device", "cpu", *argv])
            for name, argv in (
                ("torch", []), ("cuda", ["--use-kernels"]),
                ("paged", ["--use-kernels", "--page-size", "8"]),
                ("int8", ["--kv-dtype", "int8"]),
                ("int8 paged", ["--use-kernels", "--kv-dtype", "int8",
                                "--page-size", "8"]))}
    assert len(runs["torch"]["tokens"]) == 10
    assert runs["cuda"]["tokens"] == runs["torch"]["tokens"]
    assert runs["paged"]["tokens"] == runs["torch"]["tokens"]
    assert runs["int8 paged"]["tokens"] == runs["int8"]["tokens"]
    st = runs["torch"]["stats"]
    assert 0 < st.prefill_compiles <= 10


def test_serve_batched_temperature_is_seeded():
    a = serve_batched.main(["--device", "cpu", "--temperature", "0.8"])
    b = serve_batched.main(["--device", "cpu", "--temperature", "0.8"])
    assert a["tokens"] == b["tokens"]


def test_train_100m_resumes_from_latest(tmp_path):
    """A short run checkpoints at step 10; a second run on the same
    directory restores it and trains on from there: its first loss, on
    the same batch 0, is the restored model's, not the fresh init's."""
    from repro_torch.ckpt import latest_step
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    first = train_100m.main(argv + ["--steps", "11"])
    assert first["start"] is None and len(first["losses"]) == 11
    assert latest_step(str(tmp_path)) == 10
    assert first["n_params"] > 50e6
    second = train_100m.main(argv + ["--steps", "2"])
    assert second["start"] == 10 and len(second["losses"]) == 2
    assert all(np.isfinite(second["losses"]))
    assert second["losses"][0] != first["losses"][0]
