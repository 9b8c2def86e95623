"""Dry-run sweep of the port (counterpart of ``repro.launch.dryrun``):
trace one rank's step of every (architecture x input-shape x mesh) cell
at a scale preset on ``meta`` and write one JSON artifact per cell.

    # ci scale: the (2, 4) mesh, smoke-scale cells, seconds on a CPU
    PYTHONPATH=src python -m repro_torch.launch.dryrun --preset ci \\
        --mesh single

    # the reference's production scale: (16, 16), paper-scale cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --preset full \\
        --mesh single --shape decode_32k

The per-cell pipeline lives in :mod:`repro_torch.launch.lowering`, the
scale knobs in :mod:`repro_torch.launch.presets`. Nothing is allocated
and nothing runs on a card: each cell is one rank of a mesh of H100s,
its memory, cost and collectives traced on ``meta`` and priced with
``core.hardware.H100_SXM``.

Artifacts land under ``<root>/dryrun/<preset>/`` (root =
``$REPRO_TORCH_ARTIFACT_DIR`` or ``./artifacts/torch``; ``--out``
overrides), with ``_manifest.json`` recording the preset's geometry.
Skipped cells (encoder-only decode, 524k full attention) are explicit
SKIP rows with the reason ``configs.shape_skip_reason`` gives. The
``multi`` mesh (``pod``, ``data``, ``model``) is not ported yet
(ROADMAP.md, Queue 1): ``--mesh multi`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.artifacts import MANIFEST_NAME, dryrun_dir
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.lowering import lower_cell
from repro_torch.launch.presets import PRESETS, Preset, get_preset

#: The meshes the port traces (the reference's ``multi`` waits on a
#: third mesh axis).
PORTED_MESHES = ("single",)


def check_meshes(mesh_names) -> None:
    """Refuse a mesh the port has not ported."""
    for name in mesh_names:
        if name not in PORTED_MESHES:
            raise NotImplementedError(
                f"--mesh {name}: the (pod, data, model) mesh is not ported "
                f"yet; the port's Mesh and recipes have the data and model "
                f"axes only (ROADMAP.md, Queue 1: the pod axis)")


def write_manifest(preset: Preset, out_dir: str, results,
                   mesh_names=PORTED_MESHES) -> str:
    stats = {"OK": 0, "SKIP": 0, "FAIL": 0}
    for r in results:
        stats[r["status"]] = stats.get(r["status"], 0) + 1
    manifest = {
        "preset": preset.name,
        "description": preset.description,
        "shrink_archs": preset.shrink_archs,
        "meshes": {name: {"shape": list(spec.shape),
                          "axes": list(spec.axes),
                          "devices": spec.devices}
                   for name, spec in preset.meshes.items()
                   if name in mesh_names},
        "shapes": {name: {"seq_len": s.seq_len,
                          "global_batch": s.global_batch,
                          "kind": s.kind}
                   for name, s in preset.shapes.items()},
        "counts": stats,
        "cells": len(results),
        "chip": "h100-sxm",
        "torch": torch.__version__,
        "generated_unix": time.time(),
    }
    path = os.path.join(out_dir, MANIFEST_NAME)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def run_cell(preset: Preset, arch: str, shape_name: str,
             mesh_name: str) -> dict:
    """One cell's artifact; a failure is a FAIL row, never raised."""
    try:
        return lower_cell(arch, shape_name, preset.mesh_spec(mesh_name),
                          mesh_name, preset=preset)
    except Exception as e:                        # noqa: BLE001
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "preset": preset.name, "status": "FAIL",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def run_all(preset: Preset, mesh_names=PORTED_MESHES, archs=None,
            shapes=None, out_dir: str = None, verbose: bool = True):
    check_meshes(mesh_names)
    out_dir = out_dir or dryrun_dir(preset.name)
    os.makedirs(out_dir, exist_ok=True)
    archs = archs or sorted(ARCHS)
    shapes = shapes or list(SHAPES)
    results = []
    for mesh_name in mesh_names:
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch}__{shape_name}__{mesh_name}"
                art = run_cell(preset, arch, shape_name, mesh_name)
                with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                    json.dump(art, f, indent=1)
                results.append(art)
                if verbose:
                    status = art["status"]
                    if status == "OK":
                        r = art["roofline"]
                        extra = (f"{art['recipe']} peak "
                                 f"{art['memory']['peak_bytes'] / 1e9:.3f} GB"
                                 f" {r['dominant']} "
                                 f"{r['step_time_bound_s'] * 1e3:.3f} ms "
                                 f"trace={art['trace_s']:.1f}s")
                    elif status == "SKIP":
                        extra = art["reason"][:60]
                    else:
                        extra = art["error"][:90]
                    print(f"[{status:4s}] {tag:60s} {extra}", flush=True)
    # a whole sweep (every arch and shape) gets a manifest
    if archs == sorted(ARCHS) and list(shapes) == list(SHAPES):
        write_manifest(preset, out_dir, results, tuple(mesh_names))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="ci", choices=sorted(PRESETS),
                    help="scale preset: " + "; ".join(
                        f"{p.name}: {p.description}"
                        for p in PRESETS.values()))
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default=None,
                    help="artifact directory (default: "
                         "$REPRO_TORCH_ARTIFACT_DIR/dryrun/<preset> or "
                         "./artifacts/torch/dryrun/<preset>)")
    args = ap.parse_args(argv)
    preset = get_preset(args.preset)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    archs = [args.arch] if args.arch else None
    shapes = [args.shape] if args.shape else None
    t0 = time.time()
    results = run_all(preset, meshes, archs, shapes, args.out)
    bad = [r for r in results if r["status"] == "FAIL"]
    print(f"\n[{preset.name}] {len(results)} cells: "
          f"{sum(r['status'] == 'OK' for r in results)} OK, "
          f"{sum(r['status'] == 'SKIP' for r in results)} SKIP, "
          f"{len(bad)} FAIL  ({time.time() - t0:.0f}s)")
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
