"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.lowering``,
``launch.presets``): one rank of a mesh of cards traced on ``meta``.

* ``--mesh multi`` refused; the reference launcher's recipe and
  microbatches on every (arch x shape) cell;
* held to the reference's XLA dry-run (a subprocess with 8 forced host
  devices: its production compile of ``minicpm-2b/decode_32k`` and
  ``train_4k``): the argument bytes equal leaf for leaf but the port's
  pinned departures, the workload block, the recipe and the
  microbatches equal; FLOPs and collective bytes printed beside XLA's
  (XLA counts elementwise work and picks its own collectives);
* held to a live CPU-rank mesh at (1, 2) and (2, 2): every rank's
  collective counters after one prefill, one decode step and one train
  step equal the ``DryMesh`` records of the same rank, and the argument
  bytes equal the capacity model's.

The ``ci`` census (40 cells) is ``tests/test_torch_spmd_lint.py``'s,
whose pass reads it.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.capacity import (capacity, sharded_bytes,  # noqa: E402
                                           serve_preflight)
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.dist.sharding import (Placement, default_recipe,  # noqa: E402
                                       get_recipe)
from repro_torch.launch import lowering as LW  # noqa: E402
from repro_torch.launch.dryrun import main as dryrun_main  # noqa: E402
from repro_torch.launch.dryrun import run_all  # noqa: E402
from repro_torch.launch.lowering import lower_cell  # noqa: E402
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.launch.presets import CI, MeshSpec  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import (CACHE_AXES, F32_LEAVES,  # noqa: E402
                                      axes_tree, cache_spec, param_defs)

from torch_mesh_jobs import run_jobs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ===========================================================================
# The sweep and the recipe
# ===========================================================================
def test_the_multi_mesh_is_refused_naming_the_roadmap(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_all(CI, ("multi",), out_dir=str(tmp_path), verbose=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dryrun_main(["--preset", "ci", "--mesh", "multi", "--out",
                     str(tmp_path)])


@pytest.mark.parametrize("model_axis", [4, 16])
def test_the_default_recipe_and_microbatches_are_the_references(model_axis):
    from repro.configs import get_arch as jarch
    from repro.configs import get_shape as jshape
    from repro.launch.lowering import default_microbatches as jmb
    from repro.launch.lowering import default_recipe as jrecipe
    from repro_torch.configs import get_arch, get_shape
    for arch in ARCHS:
        for s in SHAPES:
            cfg, shape = get_arch(arch), get_shape(s)
            want = jrecipe(jarch(arch), jshape(s), model_axis)
            got = default_recipe(cfg, shape.kind, model_axis)
            assert (got.name, got.rules) == (want.name, dict(want.rules))
            assert LW.default_microbatches(cfg, shape) == \
                jmb(jarch(arch), jshape(s))


# ===========================================================================
# The cost and the peak of a rank's step
# ===========================================================================
@pytest.mark.parametrize("arch", ["minicpm-2b", "chatglm3-6b"])
def test_a_decode_steps_bytes_are_what_its_kernels_read(arch):
    """Each kernel is priced at its operands and outputs, not at its
    plain version's reads (the decode attention's plain version reads K
    and V in f32): a decode step reads each weight and its cache once,
    plus a few small activations."""
    from repro_torch.launch.mesh import DryMesh
    cfg, shape = CI.arch(arch), CI.shape("decode_32k")
    spec = CI.mesh_spec("single")
    case = LW.step_case(cfg, shape, DryMesh(spec.shape, spec.axes),
                        default_recipe(cfg, "decode", 4), LW.cell_runtime())
    cost = LW.cost_of(case)
    assert case.argument_bytes <= cost["bytes_accessed"] \
        <= 1.1 * case.argument_bytes
    assert cost["flops"] > 0


def test_the_dry_peak_holds_every_argument_through_the_step():
    """The caller holds a step's arguments on the card until it returns:
    under ``decode+zero3`` the head's own block stays beside the
    gathered head, which a walk that frees an argument at its last use
    (the liveness pass's) leaves out."""
    from repro_torch.analysis.graph_lint import trace
    from repro_torch.launch.mesh import DryMesh

    def step(a):
        b = a * 2                       # a's last use
        return b, torch.empty(4096, device="meta")

    g, _, _ = trace(step, torch.empty(1024, device="meta"))
    assert (g.peak(), g.peak(held=True)) == (4096 + 16384, 2 * 4096 + 16384)

    cfg, shape = CI.arch("chatglm3-6b"), CI.shape("decode_32k")
    spec = MeshSpec((2, 1), ("data", "model"))
    recipe = get_recipe("decode+zero3")
    case = LW.step_case(cfg, shape, DryMesh(spec.shape, spec.axes), recipe,
                        LW.cell_runtime())
    g, _, _ = trace(case.fn, *case.args)
    mem = LW.trace_rank(cfg, shape, spec, 0, recipe,
                        LW.cell_runtime())["memory"]
    head = math.prod(param_defs(cfg)["lm_head"].shape) * 2
    assert mem["peak_bytes"] == g.peak(held=True) >= g.peak() + head // 2


# ===========================================================================
# Held to the reference's XLA dry-run
# ===========================================================================
_REF = r"""
import json
from repro.configs import shape_skip_reason
from repro.core.roofline import collective_bytes_from_hlo
from repro.core.workload import lm_workload
from repro.launch.lowering import (build_lowered, cost_analysis_dict,
                                   default_microbatches, default_recipe)
from repro.launch.mesh import use_mesh
from repro.launch.presets import CI
from repro.models.model import ModelRuntime
CI.ensure_host_devices()
mesh = CI.build_mesh("single")
cfg = CI.arch("minicpm-2b")
out = {}
for name in ("decode_32k", "train_4k"):
    shape = CI.shape(name)
    recipe = default_recipe(cfg, shape, 4)
    m = default_microbatches(cfg, shape)
    rt = ModelRuntime(dtype="bfloat16", remat="full", attn_chunk=512)
    with use_mesh(mesh):
        compiled = build_lowered(cfg, shape, mesh, recipe, rt, m).compile()
    wl = lm_workload(cfg, shape)
    out[name] = {
        "argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
        "flops": cost_analysis_dict(compiled).get("flops", 0.0),
        "collectives": collective_bytes_from_hlo(compiled.as_text())["total"],
        "recipe": recipe.name, "microbatches": m,
        "workload": {"name": wl.name, "frontend": wl.frontend,
                     "ops": len(wl), "analytic_flops": wl.total_ops(),
                     "model_flops": wl.model_flops(),
                     "weight_bytes": wl.total_weight_bytes()}}
print("JSON" + json.dumps(out))
"""

#: Leaves whose per-rank bytes depart from the reference's spec division,
#: and by how much (bytes): the norm scales the port holds in f32 in a
#: bf16 runtime, and the attention heads (a rank holds the K/V heads its
#: query heads read: ``wk``/``wv``'s columns of one whole K/V head where
#: the spec cuts 32 columns into 4, and the cache's one K/V head where
#: the spec keeps both, 2 not dividing over 4).
DEPARTURES = {
    "decode_32k": {"final_norm/scale": 128, "blocks/ln1/scale": 256,
                   "blocks/ln2/scale": 256, "blocks/wk": 2048,
                   "blocks/wv": 2048, "cache/k": -262144,
                   "cache/v": -262144},
    "train_4k": {"blocks/wk": 6144, "blocks/wv": 6144},
}


@pytest.fixture(scope="module")
def reference_cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _REF], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][0]
    return json.loads(line[4:])


def _leaves(defs, axes, path=()):
    if isinstance(defs, dict):
        for k in defs:
            yield from _leaves(defs[k], axes[k], path + (k,))
    else:
        yield path, defs, axes or (None,) * len(defs.shape)


def departures(shape_name):
    """Per leaf, the port's rank bytes minus the reference's spec
    division (``capacity.sharded_bytes``) on the ci single mesh, where
    they differ; and the reference's total."""
    cfg, shape = CI.arch("minicpm-2b"), CI.shape(shape_name)
    sizes = CI.mesh_spec("single").axis_sizes()
    recipe = default_recipe(cfg, shape.kind, sizes["model"])
    pl = Placement(cfg, recipe, sizes)
    train = shape.kind == "train"
    dep, ref = {}, 0
    for path, d, ax in _leaves(param_defs(cfg), axes_tree(cfg)):
        ref_item = 4 if train else 2
        item = 4 if train or any(p in F32_LEAVES for p in path) else 2
        copies = 3 if train else 1              # masters + two moments
        rb = sharded_bytes(d.shape, ref_item, recipe.spec_for(ax), sizes)
        pb = math.prod(pl.local_shape(ax, d.shape)) * item
        ref += rb * copies
        if rb != pb:
            dep["/".join(path)] = (pb - rb) * copies
    rows = LW.batch_rows(shape.global_batch, sizes)
    if train:
        ref += 4 + 2 * rows * shape.seq_len * 4        # step, tokens, labels
    else:
        for k, (s, dt) in cache_spec(cfg, shape.global_batch,
                                     shape.seq_len).items():
            it = torch.empty((), dtype=dt).element_size()
            rb = sharded_bytes(s, it, recipe.spec_for(CACHE_AXES[k]), sizes)
            pb = math.prod(pl.local_shape(CACHE_AXES[k], s)) * it
            ref += rb
            if rb != pb:
                dep[f"cache/{k}"] = pb - rb
        ref += rows * 4                                 # tokens
    return dep, ref


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_held_to_the_reference_dry_run(reference_cells, shape):
    """The reference's production compile of the cell (its artifact's
    ``memory``, recipe, microbatches and workload; XLA's FLOPs of the
    scanned module and its collective link bytes printed, not held)."""
    ours = lower_cell("minicpm-2b", shape, CI.mesh_spec("single"),
                      "single", CI)
    theirs = reference_cells[shape]
    dep, ref_div = departures(shape)
    # XLA's arguments are the spec division, the port's that plus the
    # pinned departures
    assert theirs["argument_bytes"] == ref_div
    assert dep == DEPARTURES[shape]
    assert ours["memory"]["argument_bytes"] == ref_div + sum(dep.values())
    assert ours["workload"] == theirs["workload"]
    assert ours["recipe"] == theirs["recipe"]
    assert ours["microbatches"] == theirs["microbatches"]
    print(f"\n[dryrun] minicpm-2b/{shape}: flops {ours['cost']['flops']:.4g}"
          f" (XLA, scanned module: {theirs['flops']:.4g}), collective link "
          f"bytes {ours['collectives']['total']:.4g} (XLA "
          f"{theirs['collectives']:.4g})")


# ===========================================================================
# Held to a live CPU-rank mesh
# ===========================================================================
#: One prefill, one decode step and one train step at smoke size.
STEPS = (ShapeConfig("prefill_32k", 32, 2, "prefill"),
         ShapeConfig("decode_32k", 32, 4, "decode"),
         ShapeConfig("train_4k", 16, 4, "train"))
MESHES = ((1, 2), (2, 2))


@pytest.fixture(scope="module")
def live():
    cfg = CI.arch("minicpm-2b")
    whole = init_params(cfg, seed=0, device="cpu")
    out = {}
    for mesh in MESHES:
        sizes = dict(zip(("data", "model"), mesh))
        jobs = []
        for shape in STEPS:
            recipe = default_recipe(cfg, shape.kind, sizes["model"])
            rt = LW.cell_runtime()
            jobs.append(("step", (cfg, shape, recipe, rt, whole)))
        out[mesh] = run_mesh(run_jobs, mesh, jobs, devices="cpu",
                             timeout=300)
    return cfg, out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("step", range(len(STEPS)))
def test_records_equal_a_live_ranks_counters(live, mesh, step):
    cfg, out = live
    shape = STEPS[step]
    spec = MeshSpec(mesh, ("data", "model"))
    sizes = spec.axis_sizes()
    recipe = default_recipe(cfg, shape.kind, sizes["model"])
    rt = LW.cell_runtime()
    for rank, rec in enumerate(out[mesh]):
        got = rec[step]
        dry = LW.trace_rank(cfg, shape, spec, rank, recipe, rt)
        assert got["counts"] and dry["counts"] == got["counts"], rank
        assert dry["memory"]["argument_bytes"] == got["argument_bytes"]
    if shape.kind == "train":
        want = capacity(cfg, shape, mesh=sizes, recipe=recipe).argument_bytes
    elif shape.kind == "decode":
        want = serve_preflight(cfg, n_slots=shape.global_batch,
                               max_len=shape.seq_len, mesh=sizes,
                               recipe=recipe).argument_bytes
    else:
        want = capacity(cfg, shape, mesh=sizes, recipe=recipe).argument_bytes
    assert dry["memory"]["argument_bytes"] == want


def test_a_dry_mesh_is_placed_like_a_live_one():
    from repro_torch.launch.mesh import DryMesh
    m = DryMesh((2, 4), rank=6)
    assert m.coords == {"data": 1, "model": 2} and m.devices == 8
    assert m.rank_coords[6] == m.coords and m.device.type == "meta"
    assert m.backend == "dry" and m.barrier() is None
    cfg = CI.arch("minicpm-2b")
    recipe = get_recipe("decode")
    assert m.placement(cfg, recipe).kv_start == \
        Placement(cfg, recipe, m.sizes, m.coords).kv_start
    x = torch.empty(3, 8, device="meta", dtype=torch.bfloat16)
    assert m.all_reduce(x, "model").shape == (3, 8)
    assert m.all_gather(x, "model", 1).shape == (3, 32)
    assert m.world_sum(x).dtype == torch.bfloat16
    assert [r["kind"] for r in m.records] == ["all-reduce", "all-gather",
                                              "all-reduce"]
    assert [r["n"] for r in m.records] == [4, 4, 8]
    assert m.counts() == {"all-gather/4": {"calls": 1, "bytes": 48},
                          "all-reduce/4": {"calls": 1, "bytes": 96},
                          "all-reduce/8": {"calls": 1, "bytes": 96}}
