"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.lowering``,
``launch.presets``): one rank of a mesh of cards traced on ``meta``.

* the ``ci`` census over both meshes (80 cells: 64 OK, 16 SKIP, the
  manifest naming both; each ``multi`` cell's argument bytes the
  capacity model's), made once a pytest run (``torch_census``) and shared
  with ``tests/test_torch_spmd_lint.py``, whose pass reads it; the
  reference launcher's recipe and microbatches on every (arch x shape)
  cell;
* held to the reference's XLA dry-run (a subprocess with 8 forced host
  devices: its production compile of ``minicpm-2b/decode_32k`` and
  ``train_4k`` on both meshes): the argument bytes equal leaf for leaf
  but the port's pinned departures, the workload block, the recipe and
  the microbatches equal; FLOPs and collective bytes printed beside
  XLA's (XLA counts elementwise work and picks its own collectives);
* held to a live CPU-rank mesh at (1, 2), (2, 2) and (2, 2, 2) over
  ``(pod, data, model)``: every rank's collective counters after one
  prefill, one decode step and one train step equal the ``DryMesh``
  records of the same rank (by kind and group size, and by kind, axis
  and group size), and the argument bytes equal the capacity model's;
* the joined batch axis ``"pod+data"``: its groups, its records and its
  link (the network at (2, 16, 16), NVLink at (2, 2, 2)).
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
from repro_torch.configs import shape_skip_reason  # noqa: E402
from repro_torch.launch.lowering import lower_cell  # noqa: E402
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.launch.presets import CI, MeshSpec  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import (CACHE_AXES, F32_LEAVES,  # noqa: E402
                                      axes_tree, cache_spec, param_defs)

from torch_census import ci_census  # noqa: E402
from torch_mesh_jobs import run_jobs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ===========================================================================
# The sweep and the recipe
# ===========================================================================
@pytest.fixture(scope="module")
def census(tmp_path_factory):
    return ci_census(tmp_path_factory)


def test_the_census_covers_both_meshes(census):
    """80 cells, 64 OK and 16 SKIP (where ``shape_skip_reason`` says),
    none failed; the manifest lists both meshes; each ``multi`` cell's
    argument bytes are the capacity model's on its (pod, data, model)
    sizes."""
    _, out, results = census
    assert len(results) == 2 * len(ARCHS) * len(SHAPES) == 80
    counts = {s: sum(r["status"] == s for r in results)
              for s in ("OK", "SKIP", "FAIL")}
    assert counts == {"OK": 64, "SKIP": 16, "FAIL": 0}
    manifest = json.load(open(out / "_manifest.json"))
    assert manifest["cells"] == 80 and manifest["counts"] == counts
    assert manifest["meshes"] == {
        "single": {"shape": [2, 4], "axes": ["data", "model"],
                   "devices": 8},
        "multi": {"shape": [2, 2, 2], "axes": ["pod", "data", "model"],
                  "devices": 8}}
    multi = [r for r in results if r["mesh"] == "multi"]
    assert len(multi) == 40
    for r in multi:
        cfg, shape = CI.arch(r["arch"]), CI.shape(r["shape"])
        skip = shape_skip_reason(cfg, shape)
        assert r["status"] == ("SKIP" if skip else "OK"), r
        if skip:
            continue
        assert r["mesh_axes"] == {"pod": 2, "data": 2, "model": 2}
        rep = capacity(cfg, shape, mesh=r["mesh_axes"])
        assert r["memory"]["argument_bytes"] == rep.argument_bytes, r["arch"]


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
cfg = CI.arch("minicpm-2b")
out = {}
for mesh_name, name in [(a, b) for a in ("single", "multi")
                        for b in ("decode_32k", "train_4k")]:
    mesh = CI.build_mesh(mesh_name)
    shape = CI.shape(name)
    recipe = default_recipe(cfg, shape,
                            CI.mesh_spec(mesh_name).axis_sizes()["model"])
    m = default_microbatches(cfg, shape)
    rt = ModelRuntime(dtype="bfloat16", remat="full", attn_chunk=512)
    with use_mesh(mesh):
        compiled = build_lowered(cfg, shape, mesh, recipe, rt, m).compile()
    wl = lm_workload(cfg, shape)
    out[mesh_name + "/" + name] = {
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
#: and by how much (bytes), per mesh: the norm scales the port holds in
#: f32 in a bf16 runtime, and on the single mesh the attention heads (a
#: rank holds the K/V heads its query heads read: ``wk``/``wv``'s columns
#: of one whole K/V head where the spec cuts 32 columns into 4, and the
#: cache's one K/V head where the spec keeps both, 2 not dividing over
#: 4). On the multi mesh's ``model`` of 2 the two K/V heads divide, and
#: the spec's blocks are the port's.
DEPARTURES = {
    "single": {
        "decode_32k": {"final_norm/scale": 128, "blocks/ln1/scale": 256,
                       "blocks/ln2/scale": 256, "blocks/wk": 2048,
                       "blocks/wv": 2048, "cache/k": -262144,
                       "cache/v": -262144},
        "train_4k": {"blocks/wk": 6144, "blocks/wv": 6144},
    },
    "multi": {
        "decode_32k": {"final_norm/scale": 128, "blocks/ln1/scale": 256,
                       "blocks/ln2/scale": 256},
        "train_4k": {},
    },
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


def departures(shape_name, mesh_name):
    """Per leaf, the port's rank bytes minus the reference's spec
    division (``capacity.sharded_bytes``) on a ci mesh, where they
    differ; and the reference's total."""
    cfg, shape = CI.arch("minicpm-2b"), CI.shape(shape_name)
    sizes = CI.mesh_spec(mesh_name).axis_sizes()
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
    held_to_the_reference(reference_cells, shape, "single")


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_the_multi_cells_are_held_to_the_reference_dry_run(reference_cells,
                                                           shape):
    """As above on the (pod, data, model) mesh of (2, 2, 2)."""
    held_to_the_reference(reference_cells, shape, "multi")


def held_to_the_reference(reference_cells, shape, mesh):
    ours = lower_cell("minicpm-2b", shape, CI.mesh_spec(mesh), mesh, CI)
    theirs = reference_cells[f"{mesh}/{shape}"]
    dep, ref_div = departures(shape, mesh)
    # XLA's arguments are the spec division, the port's that plus the
    # pinned departures
    assert theirs["argument_bytes"] == ref_div
    assert dep == DEPARTURES[mesh][shape]
    assert ours["memory"]["argument_bytes"] == ref_div + sum(dep.values())
    assert ours["workload"] == theirs["workload"]
    assert ours["recipe"] == theirs["recipe"]
    assert ours["microbatches"] == theirs["microbatches"]
    print(f"\n[dryrun] minicpm-2b/{shape}/{mesh}: flops "
          f"{ours['cost']['flops']:.4g}"
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
#: The (pod, data, model) mesh, one spawn of 8 ranks.
POD_MESH, POD_AXES = (2, 2, 2), ("pod", "data", "model")


def _live_jobs(cfg, whole, sizes):
    return [("step", (cfg, shape, default_recipe(cfg, shape.kind,
                                                 sizes["model"]),
                      LW.cell_runtime(), whole)) for shape in STEPS]


@pytest.fixture(scope="module")
def live():
    cfg = CI.arch("minicpm-2b")
    whole = init_params(cfg, seed=0, device="cpu")
    out = {}
    for mesh in MESHES:
        sizes = dict(zip(("data", "model"), mesh))
        out[mesh] = run_mesh(run_jobs, mesh, _live_jobs(cfg, whole, sizes),
                             devices="cpu", timeout=300)
    return cfg, out


@pytest.fixture(scope="module")
def live_pod():
    cfg = CI.arch("minicpm-2b")
    whole = init_params(cfg, seed=0, device="cpu")
    sizes = dict(zip(POD_AXES, POD_MESH))
    return cfg, run_mesh(run_jobs, POD_MESH, _live_jobs(cfg, whole, sizes),
                         axes=POD_AXES, devices="cpu", timeout=300)


def _held_to_live_ranks(cfg, ranks, spec, step):
    """Every rank's counters (by kind and group size, and by kind, axis
    and group size) equal its dry records, and its argument bytes the
    trace's; returns the last trace."""
    shape = STEPS[step]
    recipe = default_recipe(cfg, shape.kind, spec.axis_sizes()["model"])
    rt = LW.cell_runtime()
    for rank, rec in enumerate(ranks):
        got = rec[step]
        dry = LW.trace_rank(cfg, shape, spec, rank, recipe, rt)
        assert got["counts"] and dry["counts"] == got["counts"], rank
        assert dry["axis_counts"] == got["axis_counts"], rank
        assert dry["memory"]["argument_bytes"] == got["argument_bytes"]
    return dry, recipe


def _capacity_arguments(cfg, shape, sizes, recipe):
    if shape.kind == "decode":
        return serve_preflight(cfg, n_slots=shape.global_batch,
                               max_len=shape.seq_len, mesh=sizes,
                               recipe=recipe).argument_bytes
    return capacity(cfg, shape, mesh=sizes, recipe=recipe).argument_bytes


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("step", range(len(STEPS)))
def test_records_equal_a_live_ranks_counters(live, mesh, step):
    cfg, out = live
    spec = MeshSpec(mesh, ("data", "model"))
    dry, recipe = _held_to_live_ranks(cfg, out[mesh], spec, step)
    assert dry["memory"]["argument_bytes"] == _capacity_arguments(
        cfg, STEPS[step], spec.axis_sizes(), recipe)


@pytest.mark.parametrize("step", range(len(STEPS)))
def test_records_equal_a_live_pod_ranks_counters(live_pod, step):
    """At (2, 2, 2) over (pod, data, model): the batch's collectives run
    over the joined ``pod+data`` groups of 4 (a train step's loss means
    and gradient sums; its IS embedding's gradient over ``pod`` after the
    ``data`` reduce-scatter), each counted under that axis live and
    dry."""
    cfg, ranks = live_pod
    spec = MeshSpec(POD_MESH, POD_AXES)
    dry, recipe = _held_to_live_ranks(cfg, ranks, spec, step)
    assert dry["memory"]["argument_bytes"] == _capacity_arguments(
        cfg, STEPS[step], spec.axis_sizes(), recipe)
    if STEPS[step].kind == "train":
        axes = {k.split("/")[1] for k in dry["axis_counts"]}
        assert {"pod+data", "pod", "data", "model"} <= axes, axes


def test_the_joined_batch_axis_is_priced_over_the_links_it_crosses():
    from repro_torch.core.roofline import axis_groups, axis_link
    assert axis_groups(dict(zip(POD_AXES, POD_MESH)), "pod+data") == \
        [(0, 2, 4, 6), (1, 3, 5, 7)]
    assert axis_link(dict(zip(POD_AXES, POD_MESH)), "pod+data") == "nvlink"
    assert axis_link({"pod": 2, "data": 16, "model": 16},
                     "pod+data") == "network"
    assert axis_link({"pod": 2, "data": 16, "model": 16}, "pod") == \
        "network"


def test_a_dry_pod_mesh_joins_the_batch_axes():
    """On (pod, data, model) the batch's collectives go over one group
    of pod x data named ``pod+data``, in ``pod * D + data`` order, and a
    subgroup is named by the axes it spans."""
    from repro_torch.launch.mesh import DryMesh
    m = DryMesh(POD_MESH, POD_AXES, rank=6)
    assert m.coords == {"pod": 1, "data": 1, "model": 0}
    assert m.batch_axis == "pod+data"
    assert (m.size("pod+data"), m.index("pod+data")) == (4, 3)
    pl = m.placement(CI.arch("minicpm-2b"), get_recipe("IS"))
    assert (pl.batch_axes, pl.batch_ranks, pl.batch_index) == (
        ("pod", "data"), 4, 3)
    assert pl.slot_block(8) == slice(6, 8)
    x = torch.empty(2, 8, device="meta")
    assert m.all_gather(x, "pod+data", 0).shape == (8, 8)
    assert m.subgroup([(0, 1), (2, 3), (4, 5), (6, 7)]) == ("model", (6, 7))
    assert m.subgroup([(0, 2, 4, 6), (1, 3, 5, 7)]) == \
        ("pod+data", (0, 2, 4, 6))
    assert m.shift(x, "pod").shape == (2, 8)
    assert [(r["kind"], r["axis"], r["n"], r["bytes"]) for r in m.records] \
        == [("all-gather", "pod+data", 4, 64),
            ("collective-permute", "pod", 2, 64)]
    assert m.axis_counts() == {
        "all-gather/pod+data/4": {"calls": 1, "bytes": 64},
        "collective-permute/pod/2": {"calls": 1, "bytes": 64}}
    assert DryMesh((2, 4)).batch_axis == "data"


#: (rows, mesh sizes) of a batch: divisible over pod x data, over one
#: axis only (16 rows over (2, 16, 16): ``pod``, where the most blocks
#: would be ``data``'s 16), over neither.
ROW_SPLITS = [
    (256, {"pod": 2, "data": 16, "model": 16}),
    (16, {"pod": 2, "data": 16, "model": 16}),
    (4, {"pod": 2, "data": 4, "model": 2}),
    (2, dict(zip(POD_AXES, POD_MESH))),
    (3, {"pod": 3, "data": 2, "model": 1}),
    (3, {"data": 2, "model": 4}),
    (8, {"data": 4, "model": 2}),
]


@pytest.mark.parametrize("rows,sizes", ROW_SPLITS)
def test_a_batch_splits_as_the_references_sanitized_spec(rows, sizes):
    """A (micro)batch's rows split over the batch axes that the
    reference's ``sanitize_spec`` keeps of the recipes' ``batch`` rule
    (``pod``, then ``data`` where the split still divides the rows): the
    train step's split (``row_split``) and the dry cells' rows
    (``lowering.batch_rows``) alike."""
    import types
    from repro.dist.sharding import RECIPES as JRECIPES
    from repro.dist.sharding import sanitize_spec as jsanitize
    from repro_torch.dist.sharding import row_split
    from repro_torch.launch.lowering import batch_rows
    mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                 axis_sizes=tuple(sizes.values()))
    ref = tuple(jsanitize(JRECIPES["IS"].spec_for(("batch",)), (rows,),
                          mesh))
    want = () if not ref or ref[0] is None else (
        (ref[0],) if isinstance(ref[0], str) else tuple(ref[0]))
    assert row_split(rows, sizes) == want
    assert batch_rows(rows, sizes) == rows // math.prod(sizes[a]
                                                        for a in want)


def test_rows_held_by_several_batch_ranks_count_once():
    """Where a batch splits over ``pod`` alone at (2, 2, 2), the two
    ``data`` ranks of a pod hold one block, which the MoE counts once
    (``Placement.row_blocks``); split over both axes, every batch rank
    holds its own block, counted after the lower ones."""
    cfg = CI.arch("qwen2-moe-a2.7b")
    blocks = {}
    for r, c in enumerate([(p, d) for p in range(2) for d in range(2)]):
        pl = Placement(cfg, get_recipe("IS"), dict(zip(POD_AXES, POD_MESH)),
                       dict(pod=c[0], data=c[1], model=0))
        blocks[r] = pl.row_blocks(("pod",))
        assert pl.row_blocks(("pod", "data")) == (4, list(range(r)))
    assert blocks == {0: (2, []), 1: (2, []), 2: (2, [0]), 3: (2, [0])}


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
