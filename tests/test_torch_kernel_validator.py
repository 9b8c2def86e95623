"""The port's Hopper kernel validator against the reference's Pallas
validator, on the CPU.

* seeded launch plans mirroring the reference's Pallas fixtures (write
  race, coverage, budget, missing VJP, dtype parity, trace error) give
  the reference's rule id, each beside the reference's ``validate_impl``
  on its own fixture (``kernel-vmem-budget`` reads ``kernel-smem-budget``
  here); a 300 KiB dynamic-smem plan, 1,025 threads and a gridDim.y of
  65,536 fire it;
* every real plan at every ``ci`` and ``h100`` case x grid point is clean,
  and the plans of the split-KV, MoE and SSD kernels cover what the
  kernels write;
* ``register_impl(..., example=...)`` rejects a racy impl, the opt-out
  variable works, the int8 impls' examples validate;
* ``run_tuning(validate=True)`` refuses a seeded broken impl before
  timing, and fills ``validation`` on the clean tree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from repro.analysis.kernel_validator import \
    validate_impl as jvalidate_impl  # noqa: E402

from repro_torch.analysis.kernel_validator import (  # noqa: E402
    check_plan, mesh_cases, validate_impl, validate_mesh_cases,
    validate_preset)
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.kernels import plan as P  # noqa: E402
from repro_torch.kernels import tune  # noqa: E402
from repro_torch.kernels.dispatch import (  # noqa: E402
    KernelValidationError, implementations, register_impl)

#: The reference's rule id -> the port's (the card has no VMEM).
PORT_RULE = {"kernel-vmem-budget": "kernel-smem-budget"}


def rule_ids(findings):
    return sorted({f.rule_id for f in findings})


def port_ids(findings):
    return sorted({PORT_RULE.get(f.rule_id, f.rule_id) for f in findings})


# ---------------------------------------------------------------------------
# Fixtures: the reference's Pallas kernels and the port's seeded plans
# ---------------------------------------------------------------------------
def _block_kernel(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0


X32 = jax.ShapeDtypeStruct((32, 8), jnp.float32)


def _pallas_fixture(grid, in_map, out_map, out_shape, in_block=(8, 8),
                    out_block=(8, 8)):
    def fn(x, **_):
        return pl.pallas_call(
            _block_kernel, grid=grid,
            in_specs=[pl.BlockSpec(in_block, in_map)],
            out_specs=pl.BlockSpec(out_block, out_map),
            out_shape=out_shape, interpret=True)(x)
    return fn


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


M32 = meta((32, 8))


def planned_impl(launches, results, body=None):
    """An impl whose launch plan is the seeded one, and whose meta path
    returns empty outputs of the plan's results."""
    def fn(x, **_):
        assert x.device.type == "meta", "the validator launches nothing"
        outs = tuple(meta(s, d) for s, d in results)
        return outs[0] if len(outs) == 1 else outs
    fn.launch_plan = lambda *a, **k: P.KernelPlan(tuple(launches),
                                                  tuple(results))
    return fn


def one_launch(grid, out_shape, tile, tiles, *, smem_dynamic=0,
               block=(256,), dtype=torch.float32, accumulates=False):
    return P.Launch("fixture", P.grid3(*grid), P.grid3(*block), 0,
                    smem_dynamic,
                    (P.Output("out", out_shape, dtype, tile, tiles),),
                    accumulates=accumulates)


def test_fixture_write_race():
    """Every block writes tile (0, 0): the reference's grid (4,)."""
    jfound = jvalidate_impl(
        "op", "pallas",
        _pallas_fixture((4,), lambda i: (i, 0), lambda i: (0, 0),
                        jax.ShapeDtypeStruct((8, 8), jnp.float32)),
        [X32], {}, ref=lambda x, **_: x[:8] * 2)
    fn = planned_impl([one_launch(
        (4,), (8, 8), (8, 8), lambda bx, by, bz: [(0 * bx, 0 * bx)])],
        [((8, 8), torch.float32)])
    found = validate_impl("op", "cuda", fn, [M32], {},
                          ref=lambda x, **_: x[:8] * 2)
    assert rule_ids(found) == port_ids(jfound) == ["kernel-write-race"]
    # declared accumulation exempts the revisit
    fn = planned_impl([one_launch(
        (4,), (8, 8), (8, 8), lambda bx, by, bz: [(0 * bx, 0 * bx)],
        accumulates=True)], [((8, 8), torch.float32)])
    assert validate_impl("op", "cuda", fn, [M32], {},
                         ref=lambda x, **_: x[:8] * 2) == []


def test_fixture_grid_coverage():
    """Grid (1,) over a 2-tile output: half stays uninitialized."""
    jfound = jvalidate_impl(
        "op", "pallas",
        _pallas_fixture((1,), lambda i: (i, 0), lambda i: (i, 0),
                        jax.ShapeDtypeStruct((16, 8), jnp.float32)),
        [X32], {}, ref=lambda x, **_: jnp.tile(x[:8] * 2, (2, 1)))
    fn = planned_impl([one_launch(
        (1,), (16, 8), (8, 8), lambda bx, by, bz: [(bx, 0 * bx)])],
        [((16, 8), torch.float32)])
    found = validate_impl("op", "cuda", fn, [M32], {},
                          ref=lambda x, **_: (x[:8] * 2).repeat(2, 1))
    assert rule_ids(found) == port_ids(jfound) == ["kernel-grid-coverage"]


@pytest.mark.parametrize("smem_dynamic,block,grid,what", [
    (300 * 1024, (256,), (1,), "opt-in limit"),
    (0, (1025,), (1,), "threads"),
    (0, (256,), (1, 65536), "in y or z"),
])
def test_fixture_smem_budget(smem_dynamic, block, grid, what):
    """The reference's 4096 x 4096 f32 block (256 MiB of VMEM) reads
    ``kernel-smem-budget`` here: 300 KiB of dynamic shared memory, a
    block past 1,024 threads, a gridDim.y past 65,535."""
    big = jax.ShapeDtypeStruct((4096, 4096), jnp.float32)
    jfound = jvalidate_impl(
        "op", "pallas",
        _pallas_fixture((1,), lambda i: (0, 0), lambda i: (0, 0), big,
                        in_block=(4096, 4096), out_block=(4096, 4096)),
        [big], {}, ref=lambda x, **_: x * 2)
    n = int(np.prod(grid))
    fn = planned_impl([one_launch(
        grid, (n, 8), (1, 8), lambda bx, by, bz: [(bx + by, 0 * bx)],
        smem_dynamic=smem_dynamic, block=block)], [((n, 8), torch.float32)])
    found = validate_impl("op", "cuda", fn, [meta((n, 8))], {},
                          ref=lambda x, **_: x * 2)
    assert rule_ids(found) == port_ids(jfound) == ["kernel-smem-budget"]
    assert what in found[0].message


def test_fixture_missing_vjp():
    jfound = jvalidate_impl("op", "pallas", lambda x, **_: x * 2, [X32], {},
                            ref=None)
    fn = planned_impl([], [((32, 8), torch.float32)])
    found = validate_impl("op", "cuda", fn, [M32], {}, ref=None)
    assert rule_ids(found) == port_ids(jfound) == ["kernel-missing-vjp"]
    # a reference whose autograd cannot run is the same finding
    found = validate_impl("op", "cuda", fn, [M32], {},
                          ref=lambda x, **_: x.detach() * 2)
    assert rule_ids(found) == ["kernel-missing-vjp"]


def test_fixture_dtype_parity():
    @jax.custom_vjp
    def widened(x):
        return x.astype(jnp.float32) * 2

    widened.defvjp(lambda x: (widened(x), None),
                   lambda _, ct: (ct.astype(jnp.bfloat16) * 2,))
    jfound = jvalidate_impl("op", "pallas", widened,
                            [jax.ShapeDtypeStruct((8, 8), jnp.bfloat16)], {},
                            ref=lambda x, **_: x * 2)
    fn = planned_impl([], [((8, 8), torch.float32)])
    found = validate_impl("op", "cuda", fn, [meta((8, 8), torch.bfloat16)],
                          {}, ref=lambda x, **_: x * 2)
    assert rule_ids(found) == port_ids(jfound) == ["kernel-dtype-parity"]


def test_fixture_trace_error():
    def broken(x, **_):
        raise ValueError("bad block size")

    jfound = jvalidate_impl("op", "pallas", broken, [X32], {},
                            ref=lambda x, **_: x)
    fn = planned_impl([], [])
    fn.launch_plan = broken
    found = validate_impl("op", "cuda", fn, [M32], {}, ref=lambda x, **_: x)
    assert rule_ids(found) == port_ids(jfound) == ["kernel-trace-error"]
    # an impl with no plan at all cannot be validated
    found = validate_impl("op", "cuda", lambda x, **_: x, [M32], {},
                          ref=lambda x, **_: x)
    assert rule_ids(found) == ["kernel-trace-error"]
    assert "no launch plan" in found[0].message


# ---------------------------------------------------------------------------
# The real plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("preset", [tune.CI, tune.H100], ids=lambda p: p.name)
def test_real_plans_are_clean_over_the_tune_grid(preset):
    assert validate_preset(preset) == []


def test_real_plans_are_clean_at_the_mesh_shapes():
    """The grouped GEMM and the SSD scan plan clean at the shapes a rank
    runs them on a mesh: qwen2-moe's 15 experts a rank (``model`` 4) and
    176 columns of its 60 (``model`` 8), mamba2's 32 and 16 SSD heads
    and zamba2's 40."""
    assert validate_mesh_cases() == []
    shapes = {(op, tuple(args[1].shape)) for op, _, args, _ in mesh_cases()}
    assert {("moe_gemm", (15, 2048, 1408)), ("moe_gemm", (60, 2048, 176)),
            ("moe_gemm", (60, 176, 2048))} <= shapes
    assert {s[1][2] for s in shapes if s[0] == "ssd_scan"} == {16, 32, 40}


def test_every_cuda_impl_carries_its_plan():
    for op in D.KERNEL_OPS:
        fn = implementations(op)["cuda"]
        assert callable(fn.launch_plan) and callable(fn.library_plan), op


def _cover(plan):
    """Every launch's findings (the coverage and race checks)."""
    return [f for launch in plan.launches
            for f in check_plan(launch, label="t")]


@pytest.mark.parametrize("G,W", [(1, 1000), (6, 129), (7, 300), (12, 1024),
                                 (16, 1), (9, 640)])
def test_splitkv_plan_covers_partials_and_output(G, W):
    from repro_torch.kernels.decode_attention import launch_plan
    plan = launch_plan(3, W, 2 * G, 2, 128, torch.bfloat16)
    assert [x.kernel.split("<")[0] for x in plan.launches] == \
        ["split_rows_kernel", "merge_kernel"]
    assert _cover(plan) == []
    assert plan.results == (((3, 2 * G, 128), torch.bfloat16),)


def test_splitkv_plan_refuses_what_the_wrapper_refuses():
    from repro_torch.kernels.decode_attention import launch_plan
    with pytest.raises(ValueError, match="group"):
        launch_plan(1, 64, 34, 2, 64, torch.float32)      # G 17
    with pytest.raises(ValueError, match="head dim"):
        launch_plan(1, 64, 4, 2, 48, torch.float32)
    with pytest.raises(TypeError, match="not supported"):
        launch_plan(1, 64, 4, 2, 64, torch.float16)


def test_moe_plan_covers_the_real_rows_under_pairing():
    """bf16: a CTA at an even position of its expert's group writes the
    group's next block too; a routing with groups of 1-5 blocks, empty
    experts and trailing blocks is covered exactly once."""
    from repro_torch.kernels.moe_gemm import BLOCK_M, moe_gemm_plan
    rng = np.random.default_rng(0)
    sizes = [0, 1, 64, 65, 200, 0, 320, 3]
    eor = np.concatenate([np.full(n, e) for e, n in enumerate(sizes)])
    eor = rng.permutation(eor)
    for dtype in (torch.bfloat16, torch.float32):
        plan = moe_gemm_plan(len(eor), 64, 300, len(sizes), dtype, eor)
        assert _cover(plan) == [], dtype
        (launch,) = plan.launches
        assert launch.grid[0] == -(-len(eor) // BLOCK_M) + len(sizes) - 1
    # the same plan with every pair-covering write dropped leaves a gap
    plan = moe_gemm_plan(len(eor), 64, 300, len(sizes), torch.bfloat16, eor)
    out = plan.launches[0].outputs[0]
    odd = P.Output(out.name, out.shape, out.dtype, out.tile,
                   lambda bx, by, bz: out.tiles(bx, by, bz)[:1],
                   required=out.required)
    launch = plan.launches[0]
    bad = P.Launch(launch.kernel, launch.grid, launch.block,
                   launch.smem_static, launch.smem_dynamic, (odd,))
    assert rule_ids(check_plan(bad, label="t")) == ["kernel-grid-coverage"]


def test_ssd_plan_covers_states_sums_and_outputs():
    from repro_torch.kernels.ssd_scan import launch_plan
    for hp, S, chunk in ((64, 1000, 256), (32, 7, 128), (48, 300, 64)):
        plan = launch_plan(2, S, 3, hp, 16, torch.float32, chunk=chunk)
        assert [x.kernel.split("<")[0] for x in plan.launches] == \
            ["ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out"]
        assert _cover(plan) == []
    with pytest.raises(ValueError, match="multiple of 16"):
        launch_plan(1, 8, 1, 40, 16, torch.float32)


#: (B, S, Hq, Hkv, D, chunk, causal) of flash plans: D 80 at chunks 64,
#: 256 and 512 over ragged S, causal and not (hubert-xlarge's forward
#: among them), and one D-64 tensor-core case.
FLASH_PLAN_CASES = [
    *((*case, dtype) for dtype in (torch.float32, torch.bfloat16)
      for case in ((1, 1000, 4, 4, 80, 64, True),
                   (2, 333, 4, 2, 80, 256, False),
                   (1, 65, 8, 1, 80, 256, True),
                   (1, 1024, 32, 32, 80, 512, True),
                   (2, 1024, 16, 16, 80, 512, False),
                   (3, 191, 4, 4, 80, 512, True))),
    (2, 1000, 36, 36, 64, 512, True, torch.bfloat16),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,chunk,causal,dtype",
                         FLASH_PLAN_CASES)
def test_flash_plan_covers_every_output_tile(B, S, Hq, Hkv, D, chunk, causal,
                                             dtype):
    """The prefill op's plan, as the validator reads it from a call's
    arguments: its blocks write every output row once, and its shared
    memory fits the card's opt-in limit (the D-80 body keeps a chunk's
    scores, so its bytes grow with ``chunk``)."""
    fn = implementations("prefill_attention")["cuda"]
    q, k, v = (torch.empty(B, S, h, D, dtype=dtype, device="meta")
               for h in (Hq, Hkv, Hkv))
    plan = fn.launch_plan(q, k, v, causal=causal, window=0, chunk=chunk)
    (launch,) = plan.launches
    assert launch.kernel == (f"flash_fwd_chunked<{P.type_name(dtype)},80>"
                             if D == 80 else f"flash_fwd_mma<{D}>")
    assert _cover(plan) == []
    assert launch.smem_static + launch.smem_dynamic <= P.SMEM_OPTIN_BYTES


def test_plan_names_the_body_the_library_chooses():
    """The body choices of csrc/*.cu, as named in _build.SERVED_BUILDS
    and the tune grids: RMSNorm's vectors a thread, flash's three bodies,
    the int8 matmul's two tiles."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant, rmsnorm
    k = rmsnorm.launch_plan((4096, 2048), torch.bfloat16).launches[0]
    assert (k.kernel, k.grid, k.block) == ("rmsnorm_vec<bf16,32,16>",
                                           (512, 1, 1), (256, 1, 1))
    assert rmsnorm.launch_plan((2048, 5120), torch.bfloat16).launches[0] \
        .kernel == "rmsnorm_wide<bf16,32>"
    assert rmsnorm.launch_plan((7, 100), torch.float32).launches[0] \
        .kernel == "rmsnorm_scalar<f32>"
    names = [fa.launch_plan(1, 64, 64, 4, 4, D, dt, aligned=al)
             .launches[0].kernel
             for D, dt, al in ((80, torch.bfloat16, True),
                               (128, torch.bfloat16, True),
                               (128, torch.bfloat16, False),
                               (64, torch.float32, True))]
    assert names == ["flash_fwd_chunked<bf16,80>", "flash_fwd_mma<128>",
                     "flash_fwd_kernel<bf16,128>", "flash_fwd_kernel<f32,64>"]
    assert [quant.quant_matmul_plan(T, 64, 64, torch.bfloat16)
            .launches[0].kernel for T in (16, 17)] == \
        ["quant_matmul_kernel<bf16>", "quant_matmul_mma<bf16>"]


# ---------------------------------------------------------------------------
# Registration and the tuner
# ---------------------------------------------------------------------------
def _racy_plan(x, scale, **_):
    rows, d = x.shape
    return P.KernelPlan((one_launch(
        (4,), (rows, d), (rows, d), lambda bx, by, bz: [(0 * bx, 0 * bx)]),),
        (((rows, d), x.dtype),))


def _racy(x, scale, **_):
    return x


_racy.launch_plan = _racy_plan


def _example():
    return (meta((8, 8)), meta((8,))), {}


def test_register_impl_rejects_broken_kernel():
    table = implementations("rmsnorm")
    assert "bad_fixture" not in table
    try:
        with pytest.raises(KernelValidationError, match="kernel-write-race"):
            register_impl("rmsnorm", "bad_fixture", example=_example)(_racy)
        assert "bad_fixture" not in table      # rejected, not registered
        # explicit opt-out (the fixture-seeding escape hatch)
        register_impl("rmsnorm", "bad_fixture", example=_example,
                      validate=False)(_racy)
        assert table["bad_fixture"] is _racy
    finally:
        table.pop("bad_fixture", None)


def test_register_impl_env_opt_out(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_VALIDATE_KERNELS", "0")
    table = implementations("rmsnorm")
    try:
        register_impl("rmsnorm", "bad_fixture", example=_example)(_racy)
        assert "bad_fixture" in table
    finally:
        table.pop("bad_fixture", None)


@pytest.mark.parametrize("op,example", [
    ("quant_matmul", D._quant_matmul_example),
    ("quant_decode_attention", D._quant_decode_example),
    ("quant_paged_decode_attention", D._quant_paged_decode_example),
])
def test_int8_examples_validate_in_full(op, example):
    """The registration examples pass every check, the torch reference's
    included (registration itself checks the plan only)."""
    args, kw = example()
    impls = implementations(op)
    assert validate_impl(op, "cuda", impls["cuda"], args, kw,
                         ref=impls["torch"]) == []


def test_tune_refuses_to_time_broken_kernels(monkeypatch):
    """run_tuning(validate=True) fails before timing anything when a
    registered impl flunks the validator."""
    timed = []
    monkeypatch.setattr(tune, "run_case",
                        lambda *a, **k: timed.append(a) or {})
    table = implementations("rmsnorm")
    try:
        register_impl("rmsnorm", "bad_fixture", validate=False)(_racy)
        with pytest.raises(KernelValidationError):
            tune.run_tuning(tune.CI, cells=[("minicpm-2b", "prefill_32k")],
                            validate=True, device="cpu")
    finally:
        table.pop("bad_fixture", None)
    assert timed == []


def test_tune_fills_validation_on_the_clean_tree():
    payload = tune.run_tuning(tune.CI, cells=[("minicpm-2b", "decode_32k")],
                              reps=1, validate=True, device="cpu",
                              log=lambda _: None)
    assert payload["validation"] == {"findings": 0, "errors": 0,
                                     "rules": []}
    assert {e["op"] for e in payload["entries"]} >= {
        "decode_attention", "paged_decode_attention", "rmsnorm"}


def test_validate_impl_partial_kwargs_reach_the_plan():
    """The tuning params reach the plan: the SSD scan's chunk sets its
    grid."""
    fn = implementations("ssd_scan")["cuda"]
    args = (meta((1, 256, 2, 64)), meta((1, 256, 2)), meta((2,)),
            meta((1, 256, 2, 16)), meta((1, 256, 2, 16)))
    grids = {c: fn.launch_plan(*args, chunk=c).launches[0].grid[1]
             for c in (32, 64, 128)}
    assert grids == {32: 8, 64: 4, 128: 2}
    assert validate_impl("ssd_scan", "cuda", fn, args, {"chunk": 64},
                         ref=implementations("ssd_scan")["torch"]) == []


# ---------------------------------------------------------------------------
# The wrappers' meta paths
# ---------------------------------------------------------------------------
def _sig(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype, t.device.type) for t in outs]


def test_every_wrapper_meta_path_matches_its_plain_version():
    """Each of the nine cuda impls, called on ``meta`` at every ``ci``
    tune-grid shape and tuning point, runs its wrapper's checks and
    returns empty ``meta`` outputs of the plain version's shapes and
    dtypes (the plain version run on ``meta``), and stands in for
    exactly one launch of its kernel (``dispatch.meta_launch``)."""
    from repro_torch.kernels.tune import cases_for_cell
    seen = set()
    for arch, shape_name in tune.CI.cells:
        for case in cases_for_cell(tune.CI.arch(arch),
                                   tune.CI.shape(shape_name),
                                   bench_batch=tune.CI.bench_batch,
                                   page_sizes=tune.CI.paged_page_sizes,
                                   device="meta"):
            args = case.make_args()
            impls = implementations(case.op)
            for params in tune.CI.grid(case.op, "cuda"):
                kw = {**case.kwargs, **dict(params)}
                launched = []
                with torch.no_grad(), D.observe_kernels(None,
                                                        launched.append):
                    got = impls["cuda"](*args, **kw)
                    want = impls["torch"](*args, **kw)
                assert _sig(got) == _sig(want), (case.op, arch, kw)
                name = "flash_attention" if case.op == "prefill_attention" \
                    else case.op
                assert launched == [name], (case.op, launched)
                seen.add(case.op)
    assert seen == set(D.KERNEL_OPS)


def test_meta_path_parity_catches_a_wrong_output():
    """``validate_impl`` holds a wrapper's meta outputs to the reference:
    one returning the wrong dtype, or failing, is a finding, though its
    plan is right; the real wrapper is clean. Registration (plan only)
    does not call it."""
    real = implementations("rmsnorm")["cuda"]
    ref = implementations("rmsnorm")["torch"]
    args = (meta((4, 64), torch.bfloat16), meta((64,)))
    assert validate_impl("rmsnorm", "cuda", real, args, {}, ref=ref) == []

    def widened(x, scale, **kw):
        return real(x, scale, **kw).float()
    widened.launch_plan = real.launch_plan
    assert rule_ids(validate_impl("rmsnorm", "cuda", widened, args, {},
                                  ref=ref)) == ["kernel-dtype-parity"]

    def refuses(x, scale, **kw):
        raise ValueError("rmsnorm: tensors on meta")
    refuses.launch_plan = real.launch_plan
    assert rule_ids(validate_impl("rmsnorm", "cuda", refuses, args, {},
                                  ref=ref)) == ["kernel-trace-error"]
    assert validate_impl("rmsnorm", "cuda", refuses, args, {}, ref=ref,
                         plan_only=True) == []
