"""The port's roofline of a mesh of cards (``repro_torch.core.roofline``):
the nine cases of ``tests/test_roofline_hlo.py`` restated as a
``DryMesh``'s records and priced as the reference prices the HLO, the
two departures of the port's own collectives pinned (a reduce-scatter is
an all-reduce and a slice, a ring shift an all-gather and a pick), the
link of each axis, and ``roofline_terms`` / ``roofline_report`` equal to
the reference's with a ``GPUSpec`` that carries ``TPU_V5E``'s numbers.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core.hardware import TPU_V5E  # noqa: E402
from repro.core.hardware import ring_collective_bytes as jring  # noqa: E402
from repro.core.roofline import collective_bytes_from_hlo  # noqa: E402
from repro.core.roofline import roofline_report as jreport  # noqa: E402
from repro.core.roofline import roofline_terms as jterms  # noqa: E402
from repro.core.workload import lm_workload as jlm  # noqa: E402

from repro_torch.core.hardware import (H100_SXM, GPUSpec,  # noqa: E402
                                       ring_collective_bytes)
from repro_torch.core.roofline import (axis_link,  # noqa: E402
                                       collective_link_bytes, dominant_term,
                                       link_bytes, roofline_report,
                                       roofline_terms)
from repro_torch.core.workload import lm_workload  # noqa: E402
from repro_torch.launch.mesh import DryMesh  # noqa: E402

#: A card with TPU_V5E's numbers: its ring moves 2 links' worth a chip.
TPU_LIKE = GPUSpec(name="tpu-v5e", peak_flops_bf16=TPU_V5E.peak_flops_bf16,
                   peak_flops_int8=TPU_V5E.peak_flops_int8,
                   peak_flops_f32=TPU_V5E.peak_flops_bf16,
                   hbm_bytes=TPU_V5E.hbm_bytes, hbm_bw=TPU_V5E.hbm_bw,
                   smem_per_block=0, sms=0,
                   nvlink_bw=2 * TPU_V5E.ici_bw_per_link,
                   network_bw=2 * TPU_V5E.ici_bw_per_link, node_size=256)

SIZES = {"data": 1, "model": 8}


def rec(kind, n, nbytes, axis="model"):
    return {"kind": kind, "axis": axis, "n": n, "bytes": nbytes, "src": None}


#: Each case of tests/test_roofline_hlo.py: its HLO line(s) and the same
#: collectives as records (``bytes``: what a rank puts in).
CASES = {
    "all_reduce_brace_groups": (
        "  %all-reduce.1 = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} "
        "%p0), channel_id=1, replica_groups={{0,1,2,3},{4,5,6,7}}, "
        "to_apply=%add",
        [rec("all-reduce", 4, 128 * 256 * 4)]),
    "all_gather_iota_groups": (
        "  %ag = bf16[32,1024]{1,0} all-gather(bf16[2,1024]{1,0} %x), "
        "channel_id=2, replica_groups=[8,16]<=[128], dimensions={0}, "
        "use_global_device_ids=true",
        [rec("all-gather", 16, 2 * 1024 * 2)]),
    "reduce_scatter_result_is_shard": (
        "  %rs = f32[4,128]{1,0} reduce-scatter(f32[32,128]{1,0} %x), "
        "channel_id=3, replica_groups={{0,1,2,3,4,5,6,7}}, "
        "dimensions={0}, to_apply=%add",
        [rec("reduce-scatter", 8, 32 * 128 * 4)]),
    "all_to_all_ring_factor": (
        "  %a2a = f32[16,64]{1,0} all-to-all(f32[16,64]{1,0} %x), "
        "channel_id=4, replica_groups={{0,1,2,3}}, dimensions={0}",
        [rec("all-to-all", 4, 16 * 64 * 4)]),
    "collective_permute_source_target_pairs": (
        "  %cp = bf16[8,128]{1,0} collective-permute(bf16[8,128]{1,0} %x), "
        "channel_id=5, source_target_pairs={{0,1},{1,2},{2,3},{3,0}}",
        [rec("collective-permute", 4, 8 * 128 * 2)]),
    "start_counted_done_ignored": (
        "  %ar-s = f32[64]{0} all-reduce-start(f32[64]{0} %x), "
        "channel_id=6, replica_groups={{0,1}}, to_apply=%add\n"
        "  %ar-d = f32[64]{0} all-reduce-done(f32[64]{0} %ar-s), "
        "channel_id=6, replica_groups={{0,1}}",
        [rec("all-reduce", 2, 64 * 4)]),
    "trivial_group_suppressed": (
        "  %ar = f32[64]{0} all-reduce(f32[64]{0} %x), channel_id=7, "
        "replica_groups={{0}}, to_apply=%add",
        [rec("all-reduce", 1, 64 * 4)]),
    "non_collective_lines_ignored": (
        "  %fusion.1 = f32[128,128]{1,0} fusion(f32[128,128]{1,0} %x), "
        "kind=kLoop, calls=%fused_computation",
        []),
    "mixed_module_accumulates_per_kind": (
        "  %ar1 = f32[100]{0} all-reduce(f32[100]{0} %a), "
        "replica_groups={{0,1,2,3}}, to_apply=%add\n"
        "  %ar2 = bf16[50]{0} all-reduce(bf16[50]{0} %b), "
        "replica_groups={{0,1,2,3}}, to_apply=%add\n"
        "  %cp = f32[10]{0} collective-permute(f32[10]{0} %c), "
        "source_target_pairs={{0,1},{1,0}}",
        [rec("all-reduce", 4, 100 * 4), rec("all-reduce", 4, 50 * 2),
         rec("collective-permute", 2, 10 * 4)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_are_priced_as_the_reference_prices_the_hlo(case):
    hlo, records = CASES[case]
    want = collective_bytes_from_hlo(hlo)
    got = collective_link_bytes(records, SIZES)
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute", "total"):
        assert got[kind] == pytest.approx(want[kind]), kind
    for kind, n in want["op_counts"].items():
        assert got["op_counts"][kind] == n, kind
    assert got["by_link"]["nvlink"] == pytest.approx(want["total"])


def test_the_ports_own_collectives_depart_as_pinned():
    """The port's reduce-scatter is an all-reduce of the whole buffer and
    a slice (twice the reference's link bytes), its ring shift an
    all-gather and a pick ((n - 1) times a permute's); a broadcast moves
    (n - 1)/n of its tensor."""
    m = DryMesh((1, 8))
    x = torch.empty(32, 128, device="meta")
    m.all_reduce(x, "model").narrow(0, 0, 4)
    m.shift(torch.empty(8, 128, device="meta", dtype=torch.bfloat16),
            "model")
    m.broadcast(torch.empty(10, device="meta"), "model")
    got = collective_link_bytes(m.records, m.sizes)
    rs = collective_bytes_from_hlo(CASES["reduce_scatter_result_is_shard"][0])
    assert got["all-reduce"] == pytest.approx(2 * rs["reduce-scatter"])
    assert got["all-gather"] == pytest.approx(7 * 8 * 128 * 2)
    assert got["broadcast"] == pytest.approx(7 / 8 * 40)
    assert got["op_counts"] == {"all-reduce": 1, "all-gather": 1,
                                "broadcast": 1, "reduce-scatter": 0,
                                "all-to-all": 0, "collective-permute": 0}


@pytest.mark.parametrize("payload,n,kind", [
    (1000, 1, "all-reduce"), (1000, 4, "all-reduce"), (999, 7, "all-gather"),
    (512, 8, "reduce-scatter"), (64, 3, "all-to-all"),
    (80, 2, "collective-permute")])
def test_ring_bytes_are_the_references(payload, n, kind):
    assert ring_collective_bytes(payload, n, kind) == \
        jring(payload, n, kind)
    with pytest.raises(ValueError):
        ring_collective_bytes(1, 2, "no-such-kind")


@pytest.mark.parametrize("sizes,axis,want", [
    ({"data": 16, "model": 16}, "model", "network"),
    ({"data": 16, "model": 16}, "data", "network"),
    ({"data": 2, "model": 4}, "model", "nvlink"),
    ({"data": 2, "model": 4}, "data", "nvlink"),
    ({"data": 2, "model": 8}, "model", "nvlink"),
    ({"data": 2, "model": 8}, "data", "network"),
    ({"data": 4, "model": 2}, "data", "nvlink"),
    ({"data": 16, "model": 1}, "world", "network"),
    ({"data": 1, "model": 3}, "world", "nvlink"),
    ({"data": 3, "model": 3}, "model", "network")])
def test_an_axis_within_a_node_of_eight_goes_over_nvlink(sizes, axis, want):
    assert axis_link(sizes, axis, H100_SXM) == want


def test_h100_links_and_terms():
    assert (H100_SXM.nvlink_bw, H100_SXM.network_bw,
            H100_SXM.node_size) == (450e9, 50e9, 8)
    t = roofline_terms(989e12, 3.35e12, {"nvlink": 450e9,
                                         "network": 50e9})
    assert t == pytest.approx({"compute_s": 1.0, "memory_s": 1.0,
                               "collective_s": 2.0})
    assert dominant_term(t) == "collective_s"
    assert link_bytes(rec("all-gather", 4, 100)) == pytest.approx(300)


@pytest.mark.parametrize("flops,byts,coll", [
    (1e12, 1e9, 1e8), (1e9, 1e12, 1e6), (1e6, 1e6, 1e12), (0.0, 0.0, 0.0)])
def test_terms_equal_the_references_at_tpu_numbers(flops, byts, coll):
    assert roofline_terms(flops, byts, {"nvlink": coll}, TPU_LIKE) == \
        pytest.approx(jterms(flops, byts, coll, TPU_V5E))


@pytest.mark.parametrize("arch,shape", [("minicpm-2b", "decode_32k"),
                                        ("qwen2-moe-a2.7b", "train_4k"),
                                        ("mamba2-1.3b", "prefill_32k")])
def test_report_equals_the_references_at_tpu_numbers(arch, shape):
    art = {"devices": 256,
           "cost": {"flops": 3.7e12, "bytes_accessed": 2.1e11},
           "collectives": {"total": 4.4e9, "by_link": {"nvlink": 4.4e9}}}
    want = jreport(jlm(arch, shape), art, TPU_V5E)
    got = roofline_report(lm_workload(arch, shape), art, TPU_LIKE)
    assert got.pop("dominant") == want.pop("dominant")
    assert got == pytest.approx(want)
    # priced by link where the artifact has them
    art2 = dict(art, collectives={"total": 4.4e9, "by_link": {
        "nvlink": 4.0e9, "network": 0.4e9}})
    rep = roofline_report(lm_workload(arch, shape), art2)
    assert rep["collective_s"] == pytest.approx(4.0e9 / 450e9
                                                + 0.4e9 / 50e9)
    assert dataclasses.replace(TPU_LIKE).nvlink_bw == 100e9
