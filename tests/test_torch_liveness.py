"""The port's storage-liveness walk and its contract guards, on the CPU.

The reference's ``jaxpr_peak`` cannot run under this host's jax (it
reads ``jax.core.Var``, gone from jax 0.9), so the walk is held to the
reference's cases with the bytes worked out by hand
(``tests/test_analysis_perf.py``):

* ``y = x * 2; return y + 1`` over 128 f32 peaks at 1024 B (two live
  512 B buffers);
* a loop of four steps keeps the carry plus the stacked outputs live;
* a view is counted once, with its storage; an in-place op allocates
  nothing;
* ``lint_arch`` is clean for the ``ci`` preset's archs (and the two other
  cache layouts), a seeded out-of-place cache write is caught, and the
  ``ATTN_CHUNK`` drift check fires on a monkeypatched default.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import liveness  # noqa: E402
from repro_torch.analysis.registry import (PRESETS,  # noqa: E402
                                           AnalysisContext, AnalysisPreset)
from repro_torch.models import model as M  # noqa: E402


def meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def test_live_peak_counts_live_bytes():
    def f(x):
        y = x * 2.0
        return y + 1.0

    # x and y live together across the first op: 2 x 512 bytes
    assert liveness.live_peak(f, meta(128)) == 1024


def test_live_peak_keeps_carry_and_stacked_outputs():
    def f(x):
        c, ys = x, []
        for _ in range(4):
            c = c + 1.0
            ys.append(c * 2.0)
        return torch.stack(ys)

    # at least the carry + the stacked output must be live
    assert liveness.live_peak(f, meta(64)) >= 64 * 4 * 5


def test_views_count_once_and_in_place_allocates_nothing():
    def view(x):
        return x[:64].reshape(8, 8) * 1.0

    def in_place(x):
        x.mul_(2.0)
        return x.add_(1.0)

    assert liveness.live_peak(view, meta(128)) == 512 + 256
    assert liveness.live_peak(in_place, meta(128)) == 512
    w, _ = liveness.walk(in_place, meta(128))
    assert w.allocs == []


def test_freed_buffers_leave_the_count():
    def f(x):
        for _ in range(10):
            x = x * 2.0        # each step frees the one before
        return x

    assert liveness.live_peak(f, meta(256)) == 2 * 1024


@pytest.mark.parametrize("arch", PRESETS["ci"].archs
                         + ("zamba2-2.7b", "qwen2-moe-a2.7b"))
def test_lint_arch_is_clean(arch):
    assert liveness.lint_arch(arch, max_len=64, page_size=8) == []


def test_decode_walk_holds_params_and_cache():
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.core.workload.torch_trace import _abstract_params
    from repro_torch.kernels.dispatch import TORCH_POLICY
    cfg = smoke_config(get_arch("minicpm-2b"))
    rt = M.ModelRuntime(remat="none", kernels=TORCH_POLICY, device="meta")
    params = _abstract_params(cfg, rt)
    cache = {k: torch.zeros(s, dtype=d, device="meta")
             for k, (s, d) in M.cache_spec(cfg, 2, 64).items()}
    w, (out, _) = liveness.walk(
        lambda p, c, t: M.decode_step(p, cfg, c, t, rt), params, cache,
        torch.zeros(2, dtype=torch.int32, device="meta"))
    floor = liveness._tree_bytes(params) + liveness._tree_bytes(cache)
    assert w.peak() >= floor
    assert all(out[k] is cache[k] for k in cache)


def test_seeded_out_of_place_cache_write_is_caught(monkeypatch):
    real = M.decode_step

    def out_of_place(params, cfg, cache, tokens, rt=M.ModelRuntime()):
        fresh = {k: t.clone() for k, t in cache.items()}
        return real(params, cfg, fresh, tokens, rt)

    monkeypatch.setattr(M, "decode_step", out_of_place)
    found = liveness.lint_arch("minicpm-2b", max_len=64, page_size=8)
    assert [f.rule_id for f in found] == ["capacity-spec-drift"]
    assert "out of place" in found[0].message
    assert "'k'" in found[0].message and "'v'" in found[0].message


def test_seeded_unread_cache_leaf_falls_below_the_floor(monkeypatch):
    real = M.cache_spec

    def padded(cfg, *a, **k):
        spec = real(cfg, *a, **k)
        return dict(spec, spare=((1 << 20,), torch.float32))

    monkeypatch.setattr(M, "cache_spec", padded)
    found = liveness.lint_arch("minicpm-2b", max_len=64, page_size=8)
    assert [f.rule_id for f in found] == ["capacity-spec-drift"]
    assert "floor" in found[0].message


def _ctx(archs=()):
    return AnalysisContext(preset=AnalysisPreset(name="t", archs=archs),
                           root=".")


def test_attn_chunk_contract_matches_live_default():
    from repro_torch.analysis.capacity import ATTN_CHUNK
    assert liveness._runtime_attn_chunk_default() == ATTN_CHUNK
    assert liveness.run_pass(_ctx()) == []


def test_attn_chunk_drift_fires(monkeypatch):
    from repro_torch.analysis import capacity
    monkeypatch.setattr(capacity, "ATTN_CHUNK", 256)
    found = liveness.run_pass(_ctx())
    assert [(f.rule_id, f.location.symbol) for f in found] == [
        ("capacity-spec-drift", "capacity/ATTN_CHUNK")]


def test_overflow_and_encoder_paths(monkeypatch):
    import types

    from repro_torch.analysis import capacity
    assert liveness.lint_arch("hubert-xlarge", max_len=64, page_size=8) == []
    monkeypatch.setattr(capacity, "H100_SXM",
                        types.SimpleNamespace(hbm_bytes=10 ** 6))
    found = liveness.lint_arch("minicpm-2b", max_len=64, page_size=8)
    assert [f.rule_id for f in found] == ["capacity-hbm-overflow"]
