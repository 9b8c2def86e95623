"""Roofline of a dry-run cell on a mesh of cards (the counterpart of
``repro.core.roofline``).

Three terms per (arch x shape x mesh), all **per card**: what one rank's
step computes, moves through its memory and sends over its links.

    compute_term    = flops / peak_flops              [s]
    memory_term     = bytes_accessed / hbm_bw         [s]
    collective_term = nvlink_bytes / nvlink_bw
                      + network_bytes / network_bw    [s]

The reference parses XLA's optimized HLO for its collectives; the port
reads the records a :class:`~repro_torch.launch.mesh.DryMesh` kept of
one rank's step (:func:`collective_link_bytes`). Each record is ring
scaled by its group size with the reference's factors
(:func:`~repro_torch.core.hardware.ring_collective_bytes`): an
all-reduce moves 2(n-1)/n of its payload through each card, a gather
(n-1)/n of the gathered tensor, a broadcast (a pipelined ring) (n-1)/n
of its tensor; a group of one moves nothing.

Which link a collective crosses follows the mesh's numbering: ranks
count with the last axis fastest, nodes hold ``chip.node_size``
consecutive ranks, and an axis whose every group stays within one node
is priced over NVLink, any other over the network (:func:`axis_link`).

The dominant term is the bottleneck of the cell.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Mapping

from repro_torch.core.hardware import H100_SXM, GPUSpec, ring_collective_bytes
from repro_torch.core.workload import Workload

#: The kinds a mesh's records carry (the port makes the first three:
#: a reduce-scatter is an all-reduce and a slice, a ring shift an
#: all-gather and a pick), in the artifact's order.
KINDS = ("all-reduce", "all-gather", "broadcast", "reduce-scatter",
         "all-to-all", "collective-permute")

#: Links a collective can cross.
LINKS = ("nvlink", "network")


def axis_groups(sizes: Mapping[str, int], axis: str):
    """The global ranks of every group of ``axis`` (``world``: one group
    of every rank), ranks counted with the last axis fastest."""
    names = list(sizes)
    if axis == "world":
        return [tuple(range(math.prod(sizes.values())))]
    k = names.index(axis)
    strides = [math.prod(list(sizes.values())[i + 1:])
               for i in range(len(names))]
    groups = []
    others = [range(sizes[a]) if a != axis else range(1) for a in names]
    for coords in itertools.product(*others):
        base = sum(c * s for c, s in zip(coords, strides))
        groups.append(tuple(base + i * strides[k]
                            for i in range(sizes[axis])))
    return groups


def axis_link(sizes: Mapping[str, int], axis: str,
              chip: GPUSpec = H100_SXM) -> str:
    """``nvlink`` when every group of ``axis`` lies within one node of
    ``chip.node_size`` consecutive ranks, else ``network``."""
    for g in axis_groups(sizes, axis):
        if len({r // chip.node_size for r in g}) > 1:
            return "network"
    return "nvlink"


def link_bytes(record: Mapping) -> float:
    """Bytes one record moves through this card's links: ``bytes`` is
    what this rank puts in (a gather's own part, an all-reduce's or a
    reduce-scatter's whole buffer)."""
    n, payload = int(record["n"]), float(record["bytes"])
    if record["kind"] == "all-gather":
        return ring_collective_bytes(payload * n, n, "all-gather")
    if record["kind"] == "broadcast":
        return ring_collective_bytes(payload, n, "all-gather")
    return ring_collective_bytes(payload, n, record["kind"])


def collective_link_bytes(records: Iterable[Mapping],
                          sizes: Mapping[str, int],
                          chip: GPUSpec = H100_SXM) -> Dict:
    """Per-card link bytes by kind, their ``total``, the ``op_counts`` by
    kind (a group of one moves and counts nothing, as in the reference),
    the bytes ``by_link`` (``nvlink``, ``network``) and the link of each
    axis the records name."""
    out: Dict = {k: 0.0 for k in KINDS}
    counts = {k: 0 for k in KINDS}
    by_link = {k: 0.0 for k in LINKS}
    links: Dict[str, str] = {}
    for r in records:
        if int(r["n"]) <= 1:
            continue
        b = link_bytes(r)
        out[r["kind"]] += b
        counts[r["kind"]] += 1
        axis = r["axis"]
        if axis not in links:
            links[axis] = axis_link(sizes, axis, chip)
        by_link[links[axis]] += b
    out["total"] = sum(out[k] for k in KINDS)
    out["op_counts"] = counts
    out["by_link"] = by_link
    out["axis_links"] = links
    return out


def roofline_terms(flops: float, bytes_accessed: float,
                   by_link: Mapping[str, float], chip: GPUSpec = H100_SXM,
                   dtype: str = "bfloat16") -> Dict[str, float]:
    """The three terms; ``by_link`` is the collective bytes over each
    link (``nvlink``, ``network``; a link left out moves nothing)."""
    return {
        "compute_s": flops / chip.peak_flops(dtype),
        "memory_s": bytes_accessed / chip.hbm_bw,
        "collective_s": (by_link.get("nvlink", 0.0) / chip.nvlink_bw
                         + by_link.get("network", 0.0) / chip.network_bw),
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


def roofline_report(workload: Workload, artifact: Dict,
                    chip: GPUSpec = H100_SXM) -> Dict:
    """The roofline row of a dry-run artifact dict.

    ``workload`` is the cell's Workload IR (the analytic LM front-end
    profile); its ``model_flops()`` (the 6ND/2ND useful-work hint) is the
    numerator of the useful-flops and roofline-fraction columns. The
    collectives are priced by link (``collectives.by_link``)."""
    chips = artifact["devices"]
    flops = artifact["cost"]["flops"]                 # per card
    byts = artifact["cost"]["bytes_accessed"]         # per card
    terms = roofline_terms(flops, byts, artifact["collectives"]["by_link"],
                           chip)
    dom = dominant_term(terms)
    mflops = workload.model_flops()                   # global useful
    global_flops = flops * chips
    useful = mflops / global_flops if global_flops else 0.0
    t_bound = max(terms.values())
    # fraction of roofline: useful global flops per second at the
    # bottleneck-bound step time, vs the fleet's peak
    roofline_frac = (mflops / t_bound) / (chips * chip.peak_flops()) \
        if t_bound > 0 else 0.0
    return {
        **{k: float(v) for k, v in terms.items()},
        "dominant": dom,
        "model_flops": float(mflops),
        "useful_flops_ratio": float(useful),
        "roofline_fraction": float(roofline_frac),
        "step_time_bound_s": float(t_bound),
    }
