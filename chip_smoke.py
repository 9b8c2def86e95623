#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on lines of its own; any failure
raises and exits non-zero (there is no CPU or plain-version fallback):

1. device and build: the card, its power limit, the ``nvcc`` build of
   every kernel source (with ptxas' register counts, named for the G-1
   instantiations of both split-KV kernels, bf16 and int8 KV, for the SSD
   scan's bf16 kernels at mamba2-1.3b's widths and for RMSNorm's at the
   served widths and row counts, and its spills);
2. every kernel of the main paths against its plain PyTorch version at
   the full-width shapes, in bf16 and f32: the attention kernels at
   minicpm-2b's (D 64; the int8 KV kernels on int8 payloads with bf16
   scales) and again at qwen2-moe's (D 128), the grouped expert GEMM at
   qwen2-moe's decode and prefill rows (f 1408 and 2048, empty experts,
   trailing blocks), the SSD scan at mamba2-1.3b's (S 1024, a ragged
   700, and 16 < chunk), the int8-weight matmul at minicpm-2b's decode
   and prefill rows (and a ragged T 37, K 2300, N 1000, a zero-scale
   column); then each is timed with CUDA events (kernel, plain version,
   one PyTorch library call as a yardstick where one exists) beside the
   least time the card could take, the attention kernels at both head
   dims and the grouped GEMM and the int8 matmul at both row counts;
   then zamba2-2.7b's shapes: the five attention kernels at its head dim
   80 (32 heads, G 1; checked in f32 and bf16 and timed, the ``d80``
   entries), the paged split-KV kernels equal to the contiguous ones bit
   for bit there (bf16 and int8 KV), flash at D 80 (the plain version's
   order), RMSNorm at d 2560 and 5120 and the SSD scan at its widths (80
   heads of 64, state 64) equal to their plain versions bit for bit;
   the timings of flash (bf16), of the grouped GEMM (bf16) and of the
   int8 matmul at T > 16 name the tensor-core body they ran
   (``mma.sync``), the four split-KV kernels', RMSNorm's and the SSD
   scan's name their body, and the grouped GEMM's checks name the body
   of each dtype (f32: the CUDA cores); the SSD scan's bound is taken at
   the bf16 tensor-core rate (the least time the card could take), with
   the f32 CUDA-core figure, its body's own unit, beside it; then the
   last-ported families' attention shapes, each checked in f32 and bf16
   and timed as the ``d80`` entries are (the ``d160``, ``g12`` and
   ``g16`` entries): stablelm-12b's head dim 160 (32 heads over 8),
   starcoder2-3b's group of 12 and chatglm3-6b's group of 16 (D 128
   over 2 kv heads); paged == contiguous bit for bit at G 16 and D 160
   (bf16 and int8 KV); RMSNorm bit for bit at d 160 (stablelm's
   qk-norm), 3584 and 4096; then the grouped GEMM and the SSD scan at
   the shapes a rank of a mesh gives them (``mesh_kernel_entries``, the
   ``e15``, ``f176``, ``nh32``, ``nh16`` and ``nh40`` entries): qwen2-moe's
   15 experts a rank at ``model`` 4 (16 decode rows and a rank's 1,024
   of a 1024-token prefill's 4,096) and its 60 experts at 176 columns at
   ``model`` 8 (16 and 4,096 rows), in f32 and bf16, the scan at
   mamba2-1.3b's 32 and 16 SSD heads (``model`` 2 and 4) and
   zamba2-2.7b's 40 (``model`` 2), each against its plain version and
   timed beside the bound (and ``torch.bmm``);

   then ``[graph]``: ``analysis.graph_lint`` under the ``h100`` preset
   on the card's host, in worker processes that trace while
   ``[validator]`` runs: the eight ``H100_ARCHS`` at full width
   (``max_len`` 4096, page 16, batch 2) traced on ``meta`` under the
   cuda policy, one arch a worker process, each arch's labels, its
   findings by rule and severity and one decode step's kernel nodes
   printed, no error or warning allowed; and after each served model's
   parity (``[graph] <arch> launches``: minicpm-2b contiguous and paged
   in bf16 and int8 KV, qwen2-moe-a2.7b and zamba2-2.7b contiguous and
   paged, mamba2-1.3b contiguous) one eager decode step on the card at
   the same shapes, every wrapper's launches over it equal to the
   traced step's kernel nodes (the ``graph`` path of the kernels line);

   then ``[validator]`` (under 120 s): the static kernel validator
   (``repro_torch.analysis.kernel_validator``) over the ``h100`` tune
   grid with no error; every case x grid point's launch plan
   (``kernels/plan.py``) equal to the library's plan export (name, grid,
   block, dynamic shared memory), and so for the served shapes the grid
   does not reach (``VALIDATOR_EXTRA``: flash at D 80 and 160 and in
   bf16, split-KV at G 12 and 16, the bf16 tensor-core bodies, RMSNorm's
   wide body) and for the mesh shapes of the grouped GEMM and the scan
   (``kernel_validator.mesh_cases``, validated statically too); each
   case launched once through its wrapper, its outputs'
   shapes and dtypes the plan's and its real plan (the MoE case's real
   routing) covering its outputs; one line per kernel symbol
   (registers, static and dynamic shared memory, local bytes, threads,
   blocks an SM), each within the card's opt-in shared memory, 65,536
   registers a block and at least one block an SM, its static shared
   memory the plan's; compute-sanitizer's memcheck, racecheck and
   initcheck over ``kernel_validator --sanitize`` where the toolkit has
   the tool and it runs on the card (a line says which, when it cannot);
   then that target itself: every kernel once at the ``ci`` shapes, f32
   and bf16, every buffer the wrappers allocate filled with NaN first,
   against its plain version;

   then the tuning path (``validate=True``: the validator's block
   printed, no error): ``run_tuning`` of the ``h100`` preset (reps 3,
   written to ``chiprun_out/calibration_h100.json``) with every launch
   count set to 0 before it: every op timed under ``torch`` and
   ``cuda``, every kernel launched, the cuda output equal to the torch
   output on every case (checked once, after the timing),
   ``KernelPolicy.from_calibration`` equal to the payload's policy, the
   ``MeasuredModel`` of every cell feasible against the H100 spec, and
   the roofline-vs-measured rows of ``kernel_model_error``;
3. serving: full minicpm-2b (40 layers, bf16, seeded random weights)
   with the default ``cuda`` kernel policy, 4 slots, max_len 1024:
   ``ServeEngine`` at admit widths 1 and 2, ``PagedServeEngine`` (page
   size 16, the equal-HBM page budget) with bf16 and int8 KV, the
   contiguous engine with int8 KV, and a shared-system-prompt trace
   with the prefix cache off and on. Before each run every kernel's
   launch count is set to 0; after it the run's kernels must have
   risen and the other paths' kernels (the int8-weight matmul among
   them, which no serving path runs) stayed at 0. Paged streams must
   equal the contiguous ones (bf16 and int8), and the warm prefix run
   must hit and prefill fewer tokens. Then a profile of full-width
   decode steps and of one 1024-token prefill (wall time against the
   device time of their kernels, kernels per step, and the shares of
   the split-KV kernel of the step's cache (bf16 contiguous, int8 paged)
   and of the MoE model's grouped GEMM);
4. logit parity at full width: teacher-forced prefill + decode steps
   under the ``cuda`` and ``torch`` policies on the same weights, and
   ``logit_parity`` for bf16 vs int8 KV and for int8 KV under both
   policies;

   then phases 3 and 4 again for full-width qwen2-moe-a2.7b (24 layers,
   60 experts top-4, dropless as served), mamba2-1.3b (48 layers,
   chunk-mode admission) and the hybrid zamba2-2.7b (54 Mamba-2 layers,
   a shared attention block at head dim 80 after every 6, chunk-mode
   admission): each model through ``ServeEngine`` and
   ``PagedServeEngine`` with equal streams (zamba2 in bf16 and int8 KV,
   four engines; the two recurrent models served at 8 and 12 layers,
   ``SERVE_RECURRENT_LAYERS``), ``moe_gemm`` launched only in the MoE runs,
   ``ssd_scan`` only in the SSM and hybrid runs and no attention kernel
   in the SSM runs; a prefill and a decode-step profile; and
   cuda-vs-torch parity: mamba2 and zamba2 in bf16 under the same
   tolerance (zamba2 also int8 KV under both policies within
   ``QUANT_PARITY_TOL``, and bf16 vs int8 KV reported),
   qwen2-moe asserted in f32 at 4 layers and reported in bf16 at full
   depth (logits, argmax and routing agreement); mamba2's prefill profile
   shows each of the SSD scan's three kernels and their share;

   then ``[families]``, the last-ported families at full width and
   depth with seeded random bf16 weights, one model on the card at a
   time: chatglm3-6b (28 layers, 2d RoPE, G 16), starcoder2-3b (30,
   LayerNorm and GELU, G 12), stablelm-12b (40, LayerNorm, qk-norm,
   head dim 160) and qwen2-vl-7b (28, M-RoPE, G 7) each through
   ``ServeEngine`` and ``PagedServeEngine`` (equal streams; stablelm
   also in int8 KV), with its attention kernels and (but for
   starcoder2, all LayerNorm) ``rmsnorm`` launched and no other
   path's; a prefill and a decode-step profile, ``[trace]``, and cuda
   vs torch logits within ``LOGIT_TOL`` (stablelm's int8 KV under both
   policies and bf16 vs int8 KV within ``QUANT_PARITY_TOL``, as
   minicpm-2b's);
   qwen2-vl prefilled from patch embeddings (B 1, S 1024) on M-RoPE
   positions of a 32 x 32 grid, cuda vs torch; hubert-xlarge (48
   layers) ``forward`` from frame embeddings at B 2, S 1024, cuda vs
   torch, only flash (non-causal, D 80) launched, profiled, and
   refused by ``ServeEngine``; each model's and the phase's time;

   after each model's profile, ``[trace]``: the trace front-end
   (``repro_torch.core.workload.torch_trace``) at the profiled prefill
   (B1 S1024) and decode step (B 4, KV 516). The trace of the call on
   the card (the served runtime, ``cuda`` policy, launch counts set to 0
   first; the model's kernels must launch, no other path's) must equal
   the abstract trace on ``meta`` (``torch`` policy) op for op: kind, K,
   N, count, FLOPs, weight bytes. Each line, ``[trace] <arch>/<prefill|
   decode> ops <n> matmul <r> activation <r> weight-bytes <r>
   predicted(traced) <ms> predicted(analytic) <ms> device <ms>``, gives
   ``diff_workloads`` against the analytic profile (the weight-matmul
   ratio asserted within 0.05) and the one-card model's prediction on
   the traced and on the analytic workload beside the device time the
   profile measured; the phase prints its own time;

   every engine run above (and each profiled prefill, and each bf16
   training run of phase 5) also prints a ``[capacity]`` line: the
   closed-form capacity model's features, predicted argument bytes and
   peak (``repro_torch.analysis.capacity``: ``serve_preflight`` at the
   engine's dtypes, which must hold the engine's parameters and cache
   to the byte) beside the run's ``max_memory_allocated`` since
   ``reset_peak_memory_stats`` (less what earlier phases left
   allocated);

   then ``[launch]``: ``repro_torch.launch.serve.main`` in-process on
   full-width minicpm-2b, ``--scenario chat_burst --preflight
   --page-size 16 --max-len 1024 --requests 8``, in bf16 and int8 KV:
   the ``deploy[...]`` and ``preflight:`` lines printed, all 8 requests
   served, rmsnorm, flash and the paged split-KV kernel of the KV dtype
   launched and no other, the deploy lower bound ``tok_p50_lb_ms`` at
   or below the measured step p50, the prefill shapes within the deploy
   inventory, the peak in a ``[capacity]`` line; the three configs the
   launcher must refuse (``stablelm-12b --slots 64 --max-len 8192
   --preflight`` and ``minicpm-2b --preflight --hbm-gb 4`` naming
   ``capacity-hbm-overflow``, ``minicpm-2b --scenario rag_long_context
   --page-size 16 --page-budget 8 --strict`` naming
   ``deploy-admission-deadlock``), each with ``memory_allocated``
   unchanged; ``repro_torch.examples.serve_batched`` in f32 under the
   ``torch`` and ``cuda`` policies (the same tokens), paged (== the
   contiguous tokens) and int8 KV; ``repro_torch.examples.train_100m``
   for 20 steps, then again on the same checkpoint directory for its
   default 300, resumed from step 10, the mean of the last 10 losses
   below the mean of the first run's first 10;

   then ``[sharded]``: the sharded engines (``repro_torch.serve.
   sharded``) on meshes whose ranks, one process each
   (``launch.mesh.run_mesh``), share the card over gloo (NCCL refuses two
   ranks on one device); the weights are drawn here once and each rank
   copies its blocks of them over CUDA IPC, and the kernel library built
   in phase 1 is loaded by every rank. Full-width minicpm-2b (bf16; 6 of
   its 40 layers, to make room for ``[sharded-train]``) at
   mesh (1, 2) through the contiguous and paged engines, bf16 and int8
   KV; full-width chatglm3-6b (bf16, contiguous; 7 of its 28 layers)
   at (1, 4), its
   vocabulary split over the ranks and each rank holding the one K/V
   head its 8 query heads read; each run teacher-forced (4 prompts of
   300 + 8 tokens: the prefills' and the 8 decode steps' logits within
   ``LOGIT_TOL`` of the one-device engine's, argmax agreement printed)
   and serving the [serve] prompts (8 new tokens each; token agreement
   and step p50 beside one device's); smoke minicpm-2b in f32 at (2, 4),
   the reference test's prompts, contiguous and paged with the prefix
   cache: tokens equal to one device's, the prefix cache hit. On every
   rank: its tokens equal rank 0's, its parameter and cache bytes equal
   to ``serve_preflight(mesh=...)``'s to the byte, its
   ``max_memory_allocated`` at most that plus its largest parameter
   block, and each mesh's kernels (minicpm-2b: RMSNorm, flash and the
   four split-KV decode kernels) launched and no other; then the MoE,
   SSM, hybrid and audio families (``sharded_family_items``, depths
   ``SHARDED_FAMILY_LAYERS``, widths uncut): qwen2-moe-a2.7b (4 of 24
   layers) at (1, 4), 15 experts a rank (expert-parallel, dropless
   decode through the grouped GEMM), in f32 teacher-forced on the
   contiguous engine (logits within ``LOGIT_TOL``) and serving the
   [serve] prompts on the paged engine (tokens equal to one device's),
   and in bf16 teacher-forced, its deviation and its argmax and routing
   agreement reported (bf16 routing flips); in one (1, 2) spawn mamba2-1.3b (8 of
   48, 32 SSD heads a rank) and zamba2-2.7b (12 of 54: two groups, so
   both shared blocks run; 40 SSD heads and 16 attention heads a rank)
   teacher-forced in bf16, and hubert-xlarge's forward (8 of 48 layers,
   B 2, S 1024 frames, bf16), logits within ``LOGIT_TOL`` of one device;
   every rank's bytes equal to the capacity model's (``capacity`` of the
   prefill for hubert), the grouped GEMM and the scan launched on every
   rank of their meshes; in a (1, 8) spawn, qwen2-moe-a2.7b expert-split
   (60 experts do not divide over 8: every expert at 176 of its 1,408
   columns a rank): layer 0's MoE FFN in bf16 with the same x on every
   rank (4 decode slots; a 1024-token prefill), held to one device's
   bf16 output within (M + 2) u max|one device| (u = 2^-8, M = 8) and no
   further from the f32 layer than one device is plus u max, then the
   model at 2 of 24 layers teacher-forced in bf16 (its deviation,
   argmax and routing agreement reported, not held: routing flips);
   then mixtral-8x22b's serving preflight at
   (1, 8), host only: a rank's bytes fit 80 GB, one card's do not. The
   launches of every rank's runs are summed into the ``sharded`` path;

   then ``[sharded-train]``: the sharded train step (``train.loop``
   under a recipe, driven on each rank by ``train.sharded.mesh_train``)
   on meshes whose ranks share the card over gloo, every mesh run held
   to the one-device train step on the same weights and global batches
   (cuda policy, remat none, f32 masters). Full-width minicpm-2b cut to
   4 layers under IS at (2, 2) (its weights split over ``data`` too):
   two f32 AdamW steps at B 4, S 256, each step's loss within
   ``TRAIN_LOSS_RTOL`` and gradient norm within ``TRAIN_GRAD_RTOL`` of
   one device's, step 0's gradient blocks of every rank within
   ``TRAIN_GRAD_RTOL`` of one device's largest gradient; a bf16 step
   within ``TRAIN_BF16_LOSS_TOL`` of one device's; its f32 state saved
   from the mesh (each rank writing the blocks it owns). Full-width
   chatglm3-6b cut to 4 layers under WS at (1, 4) (each K/V head held by
   two ranks, the vocabulary split) against one device as above; the
   minicpm-2b checkpoint restored onto one device (every leaf equal to
   its file bit for bit); GPipe on
   a (stage, data) mesh of (4, 1) at the reference test's shapes (8 tanh
   layers of 16, 6 microbatches of 2, f32): outputs within 1e-5 of the
   sequential form's, gradients within ``TRAIN_GRAD_RTOL`` of autograd
   through it. On every rank: its scalars equal rank 0's, its state
   bytes equal ``capacity(kind="train", mesh=..., recipe=...)``'s
   (parameters x 3 + 4; its peak printed beside them), RMSNorm and
   flash launched and no other kernel; the launches are summed into the
   ``sharded_train`` path. Then, in one (2, 2) spawn, full-width
   qwen2-moe-a2.7b (1 layer) under IS on the capacity path (capacity,
   slot order and aux loss global over ``data``) and mamba2-1.3b (2
   layers) under IS_seq, one f32 step each held to one device as above
   (RMSNorm and flash, RMSNorm and the scan, launched). Then the train
   launcher in-process on smoke minicpm-2b, ``--mesh 2x2 --recipe IS
   --steps 10`` with a checkpoint
   directory and its resume on ``--mesh 1x2 --recipe WS`` (finite
   losses, every rank's equal to rank 0's, the restore printed: the
   card's check of a checkpoint read onto another mesh and recipe);

   ``[dryrun]``: the dry-run of a mesh of H100s
   (``repro_torch.launch.lowering``: one rank's step traced on ``meta``
   on a ``DryMesh``, nothing allocated or launched). Started beside
   ``[graph]`` in its worker processes and read after it: every arch's
   full-width ``decode_32k`` cell of the ``full`` preset at (16, 16)
   and at (2, 16, 16) over (pod, data, model) (recipe, per-rank peak
   against the card's 80 GB, the three roofline terms priced with
   ``H100_SXM`` and the dominant one; encoder-only archs SKIP; the
   cells written under ``chiprun_out/dryrun/full/``); read before
   ``[sharded]``: chatglm3-6b's ``train_4k`` at both meshes (their
   collective terms side by side: the pod sum crosses the network) and
   ``launch.dryrun_pp.lower_pp``'s default cell (chatglm3-6b on (stage
   4, data 8, model 8), 8 microbatches of 32 x 4096, under
   ``chiprun_out/dryrun/pp/``); and the dry traces of eight ties, each
   tied in the spawn that already runs its model, the counters and peak
   stats reset around one step on every rank
   (``launch.lowering.live_step``, ``launch.dryrun_pp.live_pp_step``):
   minicpm-2b (6 of 40) at (1, 2), one prefill (B 1 S 300) and one
   decode step (B 4, 1024) and chatglm3-6b (7 of 28) at (1, 4), one
   decode step, in ``[sharded]``; qwen2-moe-a2.7b (4) at (1, 4), one
   decode step, in its ``[sharded]`` spawn, and qwen2-moe-a2.7b (2) at
   (2, 2, 2) over (pod, data, model), one decode step, in the (1, 8)
   spawn; chatglm3-6b (4) in bf16 at (2, 1) under ``decode+zero3``, one
   decode step, in ``[sharded-zero3]``; minicpm-2b (4) under IS in
   bf16, one train step (B 4 S 256), at (2, 2) and at (2, 2, 1) over
   (pod, data, model), and chatglm3-6b (4) through the pipeline-parallel
   step at (stage 2, data 1, model 2), 4 microbatches of 1 x 256, in
   ``[sharded-train]``. A tie whose mesh is not its spawn's makes it
   over the spawn's ranks. Each tie asserts, on every rank, the rank's
   collective counters (``Mesh.collectives``: kind, axis, group, calls,
   bytes) equal to the dry trace's records, its argument bytes equal to
   the trace's and (but for the PP step) to the capacity model's, the
   trace's peak (every argument held through the step) within
   ``DRYRUN_PEAK_TOL`` of the rank's ``max_memory_allocated`` over the
   step (both printed beside the capacity model's figure), and its
   kernel launches equal to the trace's kernel nodes; the ties'
   launches add to their phase's path;
5. training (``[train]``), with the card emptied first: full-width
   minicpm-2b (40 layers, f32 master weights), one f32 loss and gradient
   at B 2, S 512 under the ``cuda`` and the ``torch`` policy (TF32 off,
   remat none; the loss within 1e-5 relative, the largest gradient
   difference over all leaves within 1e-3 of the largest gradient), then
   five bf16 AdamW steps of ``make_train_step`` at B 4, S 512 on
   ``SyntheticLMData`` with the WSD schedule (finite losses, step 0
   within 0.02 of the ``torch`` policy's; step time, tokens/s, MFU, peak
   memory) and a device profile of one step, then two bf16 steps at B 2,
   S 768, a batch and length ``CALIBRATION`` was not fitted on
   (``[capacity] held-out train``, held to the same bar without a
   refit); then qwen2-moe-a2.7b at full width and 2 layers, dropless (the sort-once grouped GEMMs under
   autograd), mamba2-1.3b at full width and zamba2-2.7b at full width
   (its bf16 steps at B 2: AdamW's f32 state of 2.5 B parameters takes
   40 GB), each the same gradient check and two bf16 steps. Each
   cuda-policy run must launch its
   model's kernels and no decode or int8 kernel, each torch-policy run
   none; over the phase rmsnorm, flash, the grouped GEMM and the SSD
   scan must all have launched;
6. ``[explore]``, no timed run: the one-card analytic model
   (``repro_torch.core.analytical.gpu_model``, the reference's TPU model
   at one chip) at the shapes phases 3-5 ran (the served decoders of
   ``[families]`` among them): per model one line each
   for the profiled prefill (B1 S1024), the profiled decode step (B 4,
   KV 516) and the training run (its B, S 512 and layers, remat none,
   M 1), ``predicted <ms> (<dominant>) device <ms> wall <ms>
   device/predicted <x>`` (every wall unprofiled), and each training
   run's predicted footprint against ``max_memory_allocated`` (reported,
   no bar); asserted: every configuration run is predicted to fit the
   card (zamba2-2.7b's K/V, which the footprint leaves out for the
   hybrid family as the reference does, added and printed), mixtral-8x22b's
   prefill and 24-layer qwen2-moe training are predicted not to;
   ``explore_gpu`` at train_4k for the served models equals an
   exhaustive pass over its 14 points (qwen2-moe, chatglm3-6b,
   stablelm-12b and qwen2-vl-7b infeasible); paradigm 3
   (``explore_fpga``) reaches 0.99 of the better of paradigms 1 and 2 on
   vgg16 at KU115; the DSE's int8 proxy printed beside the bf16-vs-int8
   KV ``logit_parity`` measured for minicpm-2b, zamba2-2.7b and
   stablelm-12b; then ``[capacity]`` per kind (decode, prefill, train):
   the runs, the worst relative error of the card's coefficients, and
   every run held to ``PARITY_REL_TOL`` (0.25) and its predicted
   argument bytes to at most its measured peak; and the held-out runs
   (``[capacity] held-out``: minicpm-2b prefills at B1 S2048, B1 S4096
   and B2 S1024, mamba2-1.3b at B1 S2048, each after its model's
   profile; lines ``analysis/capacity_fit.py`` does not read) against
   the same bar without a refit, each printed as within it or missing
   it (a miss is a finding about the model's reach, recorded in
   ROADMAP.md Queue 3, not a failed run);
7. one JSON line describing the kernels (each kernel's launches by
   path: serve, tune, train, trace, launch, sharded, sharded_train and
   graph),
   the card's name and power limit, and last the JSON result line.

It exits non-zero without printing a result when no CUDA device is
available or the repository's ``src/`` is missing.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.hardware import H100_SXM  # noqa: E402  (pure data)

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), from
#: the port's one record of them.
HBM_BYTES_PER_S = H100_SXM.hbm_bw
PEAK_OPS = {"bf16_tensor": H100_SXM.peak_flops("bfloat16"),
            "int8_tensor": H100_SXM.peak_flops("int8"),
            "f32_cuda_core": H100_SXM.peak_flops("float32")}

#: f32 kernel vs plain: only the summation order differs (TF32 is off).
F32_TOL = dict(atol=5e-5, rtol=1e-5)
#: bf16: both sides compute in f32 and round once; neighbouring bf16
#: values differ by at most 2^-7 of the value.
BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)
#: The tuner's cases, cuda vs torch, all f32 on the unscaled N(0, 1)
#: inputs the reference's tuner draws: outputs reach tens in RMS (a
#: K-2304 product of unit normals), so the f32 bar's atol is taken
#: relative to the output's RMS. The SSD scan takes exp() of cumulative
#: sums of up to 256 steps of dt * A (about -200 at the chunk's end), so
#: an f32 rounding of the sum moves a decay factor by ~1e-5 of itself.
TUNE_TOL = {"ssd_scan": dict(atol=1e-4, rtol=1e-4)}
#: Teacher-forced logits, cuda vs torch policy, full width in bf16. The
#: two paths round every norm and attention output to bf16 at the same
#: places but may land one ulp apart; 40 layers carry such differences
#: to the logits. 0.25 is the repo's bound for a lossy change of
#: precision (int8 KV, max_logit_dev <= 0.25) — a kernel must not do
#: worse than a deliberate loss of precision.
LOGIT_TOL = 0.25

#: Split-KV decode shapes (B 4, positions 1023/700/300/12 of a 1024-row
#: window) and the paged layout: page size 16, 64 pages per sequence.
DECODE_POS = (1023, 700, 300, 12)

#: MoE parity in f32 (cuda vs torch policy) at full width and this
#: depth, held to the relative bar the reference holds its kernel policy
#: to (tests/test_kernel_dispatch.py): f32 routing does not flip.
MOE_PARITY_LAYERS = 4
MOE_F32_RTOL = 1e-3
PAGE_SIZE, PAGES_PER_SEQ = 16, 64
#: Keys of a kernel's check and timing at another shape: the ``d128``
#: and ``d80`` entries of the attention kernels (qwen2-moe's heads,
#: zamba2-2.7b's; flash's ``d80_hubert``, hubert-xlarge's non-causal
#: forward), the ``prefill`` entry of ``moe_gemm`` and ``quant_matmul``.
SUB_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_ms_f32_cuda_core", "library_ms", "library_call", "shape",
            "body")
#: The per-rank shapes of the grouped GEMM and the SSD scan on a mesh
#: (``mesh_kernel_entries``): qwen2-moe's 15 experts a rank (``model``
#: 4) and 176 columns of its 60 (``model`` 8); the scan at 32 and 16 SSD
#: heads (mamba2-1.3b, ``model`` 2 and 4) and 40 (zamba2-2.7b, 2).
MESH_SUB_ENTRIES = ("e15", "f176", "nh32", "nh16", "nh40")
SUB_ENTRIES = ("d128", "d80", "d80_hubert", "d160", "g12", "g16",
               "prefill", *MESH_SUB_ENTRIES)
#: The attention shapes of the last-ported families, checked and timed
#: as the ``d128`` and ``d80`` entries are: stablelm-12b's head dim 160
#: (32 heads over 8 kv heads), starcoder2-3b's group of 12 and
#: chatglm3-6b's group of 16 (D 128 over 2 kv heads).
FAMILY_SHAPES = {"d160": "stablelm-12b", "g12": "starcoder2-3b",
                 "g16": "chatglm3-6b"}
#: The instruction of the tensor-core bodies (bf16 flash prefill, the
#: bf16 grouped GEMM, the int8-weight matmul at T > 16); a timing's
#: "body" names the body it ran.
MMA = "mma.sync"
CUDA_CORE = "f32 CUDA cores"
#: The split-KV body of all four decode kernels (csrc/splitkv.cuh) at
#: G 1: D / C lanes a cache row, one 16-byte load each of K and V (C = 8
#: bf16, 16 int8 values).
ROW_BODY = "row-parallel, 16-byte lanes"
#: The split kernels' names, as the profiler and ptxas list them: the
#: bf16/f32 pair's and the int8 pair's.
BF16_KERNEL, INT8_KERNEL = "split_rows_kernel", "quant_split_kernel"
#: The SSD scan's body (csrc/ssd_scan.cu): chunks in parallel, three
#: launches (chunk states, the pass over chunks, chunk outputs), each dot
#: product one fma chain in the plain version's order.
SSD_BODY = "chunk-parallel, 3 launches, f32 CUDA cores in the plain order"
#: The SSD scan's kernels, as the profiler and ptxas name them.
SSD_KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")
#: The RMSNorm body of every served row (csrc/rmsnorm.cu rmsnorm_vec).
NORM_BODY = "a row in registers, PyTorch's reduction order"
#: Flash's body at head dim 80 (csrc/flash_chunked.cuh): the plain
#: version's chunked loop op for op, bit for bit.
PLAIN_ORDER = "f32 CUDA cores, the plain version's order"
def split_build_lines(entries, kernel: str) -> None:
    """ptxas' registers and spills of a split kernel: one line per G-1
    instantiation (the ones serving runs), then the most any other
    spills. ``entries``: ``_build.ptxas_entries`` of the build log."""
    worst = 0
    for name, regs, spill in entries:
        m = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)"
                      r"ELb([01])E", name)
        if not m:
            continue
        if m.group(3) != "1":
            worst = max(worst, spill)
            continue
        print(f"[build] {kernel}<{'f32' if m.group(1) == 'f' else 'bf16'}"
              f", D {m.group(2)}, G 1, "
              f"{'paged' if m.group(4) == '1' else 'contiguous'}>: "
              f"{regs} registers, {spill} bytes spill stores")
    print(f"[build] {kernel} at G 2-8: at most {worst} bytes spill "
          f"stores")


def served_build_lines(entries, served) -> None:
    """ptxas' registers and spills of each (label, name pattern) in
    ``served`` (``_build.SERVED_BUILDS``); fails if one is not in the
    build."""
    for label, pattern in served:
        found = [(regs, spill) for name, regs, spill in entries
                 if re.search(pattern, name)]
        check(len(found) == 1, f"{len(found)} builds of {label} "
              f"({pattern}) in the build log")
        print(f"[build] {label}: {found[0][0]} registers, {found[0][1]} "
              f"bytes spill stores")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: GPU cycles (~0.5 ms) of a spin queued before each timed call: the host
#: then enqueues the call and its end event before the card reaches the
#: start event, so a call of a few microseconds is timed on the card alone.
SPIN_CYCLES = 1_000_000


def time_ms(fn, iters: int = 30, warm: int = 3, flush=None) -> float:
    """Median CUDA-event time of one call; ``flush`` (untimed) runs
    before each call so inputs come from device memory, not L2."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(nbytes: float, ops: float, peak: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ===========================================================================
# The capacity model against the card's peaks
# ===========================================================================
#: Every measured run's ``[capacity]`` record (the features, the predicted
#: argument bytes and peak, the measured peak), checked at the end.
CAPACITY = []


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def peak_start(resident: int = 0) -> int:
    """Set the card's peak to what is allocated, just before a measured
    run; returns the bytes allocated beyond ``resident`` (the parameters
    or state the prediction counts), which the measurement leaves out."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() - resident


#: Runs the capacity fit (``analysis/capacity_fit.py``) has not seen,
#: held to PARITY_REL_TOL with the card's CALIBRATION as it stands: each
#: (batch, length) prefilled once after the model's profile.
HELD_OUT = []
HELD_OUT_PREFILLS = {"minicpm-2b": ((1, 2048), (1, 4096), (2, 1024)),
                     "mamba2-1.3b": ((1, 2048),)}
#: (batch, length) of minicpm-2b's held-out bf16 training run: the fit
#: took B 4 S 512 (and the other models' runs); B 2 S 768 moves every
#: feature (tokens x 0.75, scores x 0.75).
HELD_OUT_TRAIN = (2, 768)


def held_out_prefills(cfg, params, rt):
    """One cuda-policy prefill per HELD_OUT_PREFILLS entry of ``cfg``,
    its peak against ``capacity()``'s prediction, printed as
    ``[capacity] held-out {json}`` (a line the fit does not read)."""
    import torch
    from repro_torch.analysis.capacity import capacity
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import prefill
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for B, S in HELD_OUT_PREFILLS.get(cfg.name, ()):
        shape = ShapeConfig(f"prefill_b{B}_s{S}", S, B, "prefill")
        with torch.no_grad():
            toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                 device=dev)
            other = peak_start(tree_bytes(params))
            cache, _ = prefill(params, cfg, {"tokens": toks}, S, rt)
            del cache
            torch.cuda.synchronize()
        rep = capacity(cfg, shape, dtype=rt.dtype, kv_dtype=rt.kv_dtype)
        measured = torch.cuda.max_memory_allocated() - other
        rec = dict(arch=cfg.name, kind="prefill", engine=f"prefill B{B} S{S}",
                   kv_dtype=rt.kv_dtype or "bf16", features=rep.features,
                   argument_bytes=rep.argument_bytes,
                   peak_bytes=rep.peak_bytes, measured_bytes=measured,
                   other_bytes=other,
                   rel_err=abs(measured - rep.peak_bytes) / measured)
        print("[capacity] held-out " + json.dumps(rec))
        HELD_OUT.append(rec)


def capacity_record(arch, kind, engine, kv_dtype, rep, other):
    """Print and keep one ``[capacity]`` line: the prediction ``rep``
    (a ``CapacityReport``) beside the peak since ``peak_start``, less the
    ``other`` bytes it returned."""
    import torch
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - other
    rec = dict(arch=arch, kind=kind, engine=engine,
               kv_dtype=(kv_dtype or "bf16") if kind != "train" else "-",
               features=rep.features,
               argument_bytes=rep.argument_bytes, peak_bytes=rep.peak_bytes,
               measured_bytes=measured, other_bytes=other,
               rel_err=abs(measured - rep.peak_bytes) / measured)
    print("[capacity] " + json.dumps(rec))
    CAPACITY.append(rec)
    return rec


# ===========================================================================
# Phase 2: kernels against their plain versions
# ===========================================================================
def kernel_phase(cfg, moe_cfg, ssm_cfg, hyb_cfg):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d = cfg.d_model
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_                      # 256 MB > the 50 MB L2

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    entries = {}

    def compare(name, got, want, dtype, what):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"{name} {what}: "
              f"non-finite output")
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda m: f"{name} {what}: {m}")
        print(f"[kernels] {name:<16} {what:<40} max|err| {err:.3e} "
              f"(tol atol {tol['atol']:g} rtol {tol['rtol']:g}) ok")
        return err

    # --- rmsnorm: prefill rows (2 x 1024) and decode rows (4) ------------
    s = torch.randn(d, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (4, 2048):
            x = rnd(rows, d, dtype=dtype)
            err = compare("rmsnorm", rmsnorm(x, s, eps=1e-6),
                          rmsnorm_plain(x, s, eps=1e-6), dtype,
                          f"({rows}, {d}) {str(dtype)[6:]}")
    x = rnd(2048, d, dtype=torch.bfloat16)
    sb = s.to(torch.bfloat16)
    nbytes = 2 * x.numel() * 2 + s.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * x.numel(), "f32_cuda_core")
    entries["rmsnorm"] = dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:25", max_abs_err=err,
        ms=time_ms(lambda: rmsnorm(x, s, eps=1e-6), flush=flush),
        plain_ms=time_ms(lambda: rmsnorm_plain(x, s, eps=1e-6), flush=flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.rms_norm(x, (d,), sb, 1e-6),
                           flush=flush),
        library_call="F.rms_norm, bf16 weight", body=NORM_BODY,
        shape=f"x (2048, {d}) bf16")

    # --- attention at D 64 (minicpm-2b), then D 128 (qwen2-moe) ----------
    B, W = 4, 1024
    mask = (torch.arange(W, device=dev)[None, :]
            <= torch.tensor(DECODE_POS, device=dev)[:, None])
    entries["flash_attention"] = flash_entry(cfg, rnd, compare, flush,
                                             ((2, 1024), (1, 700)))
    entries["decode_attention"] = decode_entry(cfg, rnd, compare, flush, mask)
    entries.update(decode_variants(cfg, gen, rnd, compare, flush, mask))
    d128 = {"flash_attention": flash_entry(moe_cfg, rnd, compare, flush,
                                           ((1, 1024),)),
            "decode_attention": decode_entry(moe_cfg, rnd, compare, flush,
                                             mask),
            **decode_variants(moe_cfg, gen, rnd, compare, flush, mask)}
    for name, e in d128.items():
        entries[name]["d128"] = {k: e[k] for k in SUB_KEYS if k in e}
    # --- zamba2-2.7b: attention at D 80, RMSNorm and the scan bit for bit
    d80 = {"flash_attention": flash_entry(hyb_cfg, rnd, compare, flush,
                                          ((1, 1024), (2, 333)),
                                          body=PLAIN_ORDER),
           "decode_attention": decode_entry(hyb_cfg, rnd, compare, flush,
                                            mask),
           **decode_variants(hyb_cfg, gen, rnd, compare, flush, mask)}
    for name, e in d80.items():
        entries[name]["d80"] = {k: e[k] for k in SUB_KEYS if k in e}
    from repro_torch.configs import get_arch
    enc = flash_entry(get_arch("hubert-xlarge"), rnd, compare, flush,
                      ((2, 1024),), body=PLAIN_ORDER, causal=False)
    entries["flash_attention"]["d80_hubert"] = {k: enc[k] for k in SUB_KEYS
                                                if k in enc}
    paged_equals_contiguous(hyb_cfg, gen, mask)
    bit_for_bit_at(hyb_cfg, gen, rnd)
    # --- the last-ported families: D 160, G 12 and 16 ----------------------
    for key, arch in FAMILY_SHAPES.items():
        fcfg = get_arch(arch)
        new = {"flash_attention": flash_entry(fcfg, rnd, compare, flush,
                                              ((1, 1024), (2, 333))),
               "decode_attention": decode_entry(fcfg, rnd, compare, flush,
                                                mask),
               **decode_variants(fcfg, gen, rnd, compare, flush, mask)}
        for name, e in new.items():
            entries[name][key] = {k: e[k] for k in SUB_KEYS if k in e}
    for arch in ("chatglm3-6b", "stablelm-12b"):     # G 16, D 160
        paged_equals_contiguous(get_arch(arch), gen, mask)
    rmsnorm_bit_for_bit(gen, rnd, {160: (4, 128, 2048, 32768),
                                   3584: (4, 2048), 4096: (4, 2048)})
    entries["moe_gemm"] = moe_gemm_kernel(moe_cfg, gen, rnd, compare, flush)
    entries["ssd_scan"] = ssd_scan_kernel(ssm_cfg, gen, rnd, compare, flush)
    mesh_kernel_entries(entries, moe_cfg, gen, rnd, compare, flush)
    entries["quant_matmul"] = quant_matmul_kernel(cfg, gen, rnd, compare,
                                                  flush)
    for e in entries.values():
        for label, t in (("", e), *((f"{k} ", e[k]) for k in SUB_ENTRIES
                                    if k in e)):
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ms")
            body = f" [{t['body']}]" if "body" in t else ""
            floor = (f", f32 CUDA-core floor "
                     f"{t['bound_ms_f32_cuda_core']:.4f} ms"
                     if "bound_ms_f32_cuda_core" in t else "")
            print(f"[time] {e['name']:<16} {label}{t['shape']}{body}: "
                  f"kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                  f"{lib} ({t.get('library_call', e['library_call'])}), "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}){floor}")
    del scratch
    return entries


def flash_entry(cfg, rnd, compare, flush, shapes, body=MMA, causal=True):
    """Flash prefill at ``cfg``'s heads against its plain version at each
    (B, S) of ``shapes`` in f32 and bf16, then timed in bf16 at the
    first; ``body`` names the bf16 body that runs. The D-80 body (the
    plain order on the f32 CUDA cores) also carries its floor at the f32
    rate, ``bound_ms_f32_cuda_core``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mode = "causal" if causal else "non-causal"
    for dtype in (torch.float32, torch.bfloat16):
        for B, S in shapes:
            q = rnd(B, S, H, D, dtype=dtype)
            k = rnd(B, S, Hkv, D, dtype=dtype)
            v = rnd(B, S, Hkv, D, dtype=dtype)
            err = compare("flash_attention",
                          flash_attention(q, k, v, causal=causal),
                          flash_attention_plain(q, k, v, causal=causal),
                          dtype, f"B{B} S{S} H{H} Hkv{Hkv} D{D} {mode} "
                          f"{str(dtype)[6:]}")
    B, S = shapes[0]
    q, k, v = (rnd(B, S, h, D, dtype=torch.bfloat16) for h in (H, Hkv, Hkv))
    pairs = S * (S + 1) // 2 if causal else S * S   # attended (q, k) pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    ops = 4 * D * pairs * B * H
    b_ms, b_by = bound(nbytes, ops, "bf16_tensor")
    floor = ({"bound_ms_f32_cuda_core": bound(nbytes, ops, "f32_cuda_core")[0]}
             if body == PLAIN_ORDER else {})
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:89", max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=causal),
                   flush=flush),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v,
                                                       causal=causal),
                         iters=10, flush=flush),
        bound_ms=b_ms, bound_by=b_by, **floor,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), flush=flush),
        library_call=f"SDPA, {mode}", mma=MMA, body=body,
        shape=f"B{B} S{S} Hq{H} Hkv{Hkv} D{D} {mode} bf16")


def decode_entry(cfg, rnd, compare, flush, mask):
    """The contiguous split-KV decode kernel at ``cfg``'s heads (B 4, W
    1024, ragged ``mask``) against its plain version, timed in bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, W = mask.shape
    for dtype in (torch.float32, torch.bfloat16):
        q = rnd(B, H, D, dtype=dtype)
        kc, vc = rnd(B, W, Hkv, D, dtype=dtype), rnd(B, W, Hkv, D,
                                                     dtype=dtype)
        err = compare("decode_attention", decode_attention(q, kc, vc, mask),
                      decode_attention_plain(q, kc, vc, mask), dtype,
                      f"B{B} W{W} H{H} Hkv{Hkv} D{D} {str(dtype)[6:]}")
    valid = int(mask.sum())
    nbytes = 2 * (2 * q.numel() + 2 * valid * Hkv * D) + mask.numel()
    b_ms, b_by = bound(nbytes, 4 * D * H * valid, "bf16_tensor")
    q4, k4, v4 = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    m4 = mask[:, None, None, :]
    return dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:44",
        max_abs_err=err,
        ms=time_ms(lambda: decode_attention(q, kc, vc, mask), flush=flush),
        plain_ms=time_ms(lambda: decode_attention_plain(q, kc, vc, mask),
                         flush=flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, enable_gqa=True), flush=flush),
        library_call="SDPA, bool mask", body=ROW_BODY,
        shape=f"B{B} W{W} Hq{H} Hkv{Hkv} D{D} bf16, {valid} valid rows")


def moe_case(gen, rnd, E, T, d_in, f_out, dtype, empty, trailing=True):
    """T rows routed uniformly over E experts of d_in -> f_out, experts
    0..empty-1 left without a row: the rows, weights, routes, the
    kernel's sorted arguments, the inverse order and the experts used.
    With ``trailing`` the sort must leave a trailing block, and no row
    in it."""
    import torch
    from repro_torch.kernels.moe_gemm import (BLOCK_M, block_rows,
                                              sort_by_expert)
    dev = torch.device("cuda")
    x = rnd(T, d_in, dtype=dtype)
    w = (torch.randn(E, d_in, f_out, generator=gen, device=dev)
         / math.sqrt(d_in)).to(dtype)
    eor = torch.randint(0, E, (T,), generator=gen, device=dev)
    eor = torch.where(eor < empty, eor + empty, eor)
    xp, be, inv, Tp = sort_by_expert(x, eor, E, BLOCK_M)
    rows = block_rows(inv, Tp // BLOCK_M, BLOCK_M)
    tail = be == E
    check(not bool(rows[tail].any()) and (bool(tail.any()) or not trailing),
          f"moe_gemm T{T} E{E}: no trailing block, or one holding rows")
    return x, w, eor, (xp, w, be, rows), inv, int(torch.unique(eor).numel())


def moe_checked(gen, rnd, compare, E, T, d, f, label, empty=4,
                trailing=True):
    """The grouped GEMM against its plain version at T rows of both
    shapes (d -> f, f -> d), in f32 (the CUDA cores) and bf16 (the
    tensor cores); returns the largest error."""
    import torch
    from repro_torch.kernels.moe_gemm import (grouped_gemm_padded,
                                              grouped_gemm_padded_plain)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for d_in, f_out in ((d, f), (f, d)):
            _, _, _, args, inv, used = moe_case(gen, rnd, E, T, d_in, f_out,
                                                dtype, empty, trailing)
            body = CUDA_CORE if dtype == torch.float32 else MMA
            err = max(err, compare(
                "moe_gemm", grouped_gemm_padded(*args)[inv],
                grouped_gemm_padded_plain(*args)[inv], dtype,
                f"{label} T{T} {d_in}->{f_out} {used}/{E} "
                f"{str(dtype)[6:]} {body}"))
    return err


def moe_timed(gen, rnd, flush, err, E, T, d, f, what=""):
    """The bf16 grouped GEMM at T rows over E experts of d -> f, every
    expert used: kernel, plain version and ``torch.bmm`` over the present
    experts' padded rows (the layout not timed) beside the bound."""
    import torch
    from repro_torch.kernels.moe_gemm import (grouped_gemm_padded,
                                              grouped_gemm_padded_plain)
    x, w, eor, args, inv, used = moe_case(gen, rnd, E, T, d, f,
                                          torch.bfloat16, 0, trailing=False)
    present = torch.unique(eor)
    counts = (eor[:, None] == present[None, :]).sum(0)
    xe = x.new_zeros(len(present), int(counts.max()), d)
    for j, e in enumerate(present.tolist()):
        rows = x[eor == e]
        xe[j, :len(rows)] = rows
    ws = w[present].contiguous()
    nbytes = 2 * (T * d + used * d * f + T * f) + 8 * len(args[2])
    b_ms, b_by = bound(nbytes, 2 * T * d * f, "bf16_tensor")
    return dict(max_abs_err=err,
                ms=time_ms(lambda: grouped_gemm_padded(*args), flush=flush),
                plain_ms=time_ms(lambda: grouped_gemm_padded_plain(*args),
                                 iters=10, flush=flush),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: torch.bmm(xe, ws), flush=flush),
                body=MMA,
                shape=f"T{T} rows d{d} f{f} bf16, {used}/{E} experts, "
                      f"block {args[0].shape[0] // len(args[2])}{what}")


def moe_gemm_kernel(cfg, gen, rnd, compare, flush):
    """The grouped expert GEMM at qwen2-moe's widths: decode (4 slots x
    top-4 = 16 rows) and a 1024-token prefill (4096 rows), the gate/up
    shape (d 2048 -> f 1408) and the down shape (1408 -> 2048), with
    empty experts and the trailing blocks the sort's static bound
    leaves. bf16 runs the tensor-core body, f32 the CUDA-core one.
    Timed at the decode gate/up shape (and the prefill one)."""
    m = cfg.moe
    E, K, d, f = m.n_experts, m.experts_per_token, cfg.d_model, m.d_expert
    err = 0.0
    for T, label in ((4 * K, "decode"), (1024 * K, "prefill")):
        err = max(err, moe_checked(gen, rnd, compare, E, T, d, f, label))
    dec = moe_timed(gen, rnd, flush, err, E, 4 * K, d, f)
    pre = moe_timed(gen, rnd, flush, err, E, 1024 * K, d, f)
    return dict(name="moe_gemm", route="cuda",
                source="src/repro_torch/kernels/csrc/moe_gemm.cu",
                replaces="src/repro/kernels/moe_gemm.py:32",
                library_call="torch.bmm over the present experts' padded "
                             "rows, layout not timed", mma=MMA,
                prefill={k: pre[k] for k in SUB_KEYS if k in pre}, **dec)


def mesh_kernel_entries(entries, moe_cfg, gen, rnd, compare, flush):
    """The grouped GEMM and the SSD scan at the shapes a rank of a mesh
    runs them (``analysis.kernel_validator.MESH_KERNEL_CELLS``), each
    against its plain version and timed, as the ``moe_gemm`` /
    ``ssd_scan`` sub-entries ``MESH_SUB_ENTRIES`` names: qwen2-moe's 15
    experts a rank at ``model`` 4 (a rank's 1,024 of a 1024-token
    prefill's 4,096 rows, and 16 decode rows), its 60 experts at 176
    columns at ``model`` 8 (all 4,096 rows), and the scan at the SSD
    heads of mamba2-1.3b at ``model`` 2 and 4 and of zamba2-2.7b at 2."""
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import DECODE_RECIPE, Placement
    from repro_torch.models.ssm import ssm_dims
    m, d = moe_cfg.moe, moe_cfg.d_model
    for key, model, T in (("e15", 4, 1024), ("f176", 8, 4096)):
        pl = Placement(moe_cfg, DECODE_RECIPE, {"data": 1, "model": model})
        E = pl.n_experts
        f = m.d_expert // (model if pl.moe_split == "ffn" else 1)
        check(key in (f"e{E}", f"f{f}"), f"{key}: the placement gives E {E}"
              f" f {f} at model {model}")
        what = (f", {pl.moe_split} split at model {model}")
        err = max(moe_checked(gen, rnd, compare, E, 4 * m.experts_per_token,
                              d, f, f"{key} decode", empty=0,
                              trailing=False),
                  moe_checked(gen, rnd, compare, E, T, d, f,
                              f"{key} prefill", empty=0, trailing=False))
        t = moe_timed(gen, rnd, flush, err, E, T, d, f, what)
        entries["moe_gemm"][key] = {k: t[k] for k in SUB_KEYS if k in t}
    for key, arch, model in (("nh32", "mamba2-1.3b", 2),
                             ("nh16", "mamba2-1.3b", 4),
                             ("nh40", "zamba2-2.7b", 2)):
        cfg = get_arch(arch)
        pl = Placement(cfg, DECODE_RECIPE, {"data": 1, "model": model})
        check(key == f"nh{pl.ssm_heads}", f"{key}: the placement gives "
              f"{pl.ssm_heads} SSD heads at model {model}")
        dims = ssm_dims(cfg)
        t = ssd_checked_timed(gen, rnd, compare, flush, pl.ssm_heads,
                              dims["hp"], dims["N"], cfg.ssm.chunk_size,
                              f"{arch} at model {model}")
        entries["ssd_scan"][key] = {k: t[k] for k in SUB_KEYS if k in t}


def ssd_inputs(gen, rnd, b, S, nh, hp, N, dtype):
    """The scan's x, dt (softplus of N(-2, 1)), A (-exp of N(0, 0.25)),
    B and C (N(0, 1) / N^0.25) for b sequences of S."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    x = rnd(b, S, nh, hp, dtype=dtype)
    dt = F.softplus(torch.randn(b, S, nh, generator=gen, device=dev) - 2.0)
    A = -torch.exp(torch.randn(nh, generator=gen, device=dev) * 0.5)
    B, C = ((torch.randn(b, S, nh, N, generator=gen, device=dev)
             / N ** 0.25).to(dtype) for _ in range(2))
    return x, dt, A, B, C


def ssd_timed(gen, rnd, flush, err, nh, hp, N, L, what=""):
    """The bf16 scan at B1 S1024 timed (kernel, plain version) beside
    the bound."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    b, S = 1, 1024
    args = ssd_inputs(gen, rnd, b, S, nh, hp, N, torch.bfloat16)
    # what the chunked algorithm needs per (sequence, head, chunk): the
    # causal C.B scores and their product with x, the carried-state term
    # and the state update, each 2 operations per multiply-add
    nc = -(-S // L)
    pairs = L * (L + 1) // 2
    ops = b * nh * nc * 2 * (pairs * N + pairs * hp + 2 * L * N * hp)
    nbytes = (2 * b * S * nh * (2 * hp + 2 * N) + 4 * b * S * nh + 4 * nh
              + 4 * b * nh * hp * N)
    b_ms, b_by = bound(nbytes, ops, "bf16_tensor")
    return dict(max_abs_err=err,
                ms=time_ms(lambda: ssd_scan(*args, chunk=L), flush=flush),
                plain_ms=time_ms(lambda: ssd_chunked(*args, L), iters=10,
                                 flush=flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, body=SSD_BODY,
                bound_ms_f32_cuda_core=bound(nbytes, ops, "f32_cuda_core")[0],
                shape=f"b{b} S{S} nh{nh} hp{hp} N{N} chunk {L} bf16{what}")


def ssd_checked_timed(gen, rnd, compare, flush, nh, hp, N, L, what):
    """The scan at nh heads against its plain version at B1 S1024 in f32
    and bf16 (outputs and final state), then timed."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = ssd_inputs(gen, rnd, 1, 1024, nh, hp, N, dtype)
        (y, h), (yw, hw) = ssd_scan(*args, chunk=L), ssd_chunked(*args, L)
        label = f"{what} nh{nh} hp{hp} N{N} {str(dtype)[6:]}"
        err = max(err, compare("ssd_scan", y, yw, dtype, f"y {label}"))
        compare("ssd_scan", h, hw, torch.float32, f"state {label}")
    return ssd_timed(gen, rnd, flush, err, nh, hp, N, L, f", {what}")


def ssd_scan_kernel(cfg, gen, rnd, compare, flush):
    """The chunked SSD scan at mamba2-1.3b's widths (64 heads of 64, state
    128, chunk 256): a 1024-token prefill, a ragged 700 (two sequences)
    and a 16-token chunk-mode floor (S < chunk). Timed at B1 S1024."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    from repro_torch.models.ssm import ssm_dims

    dims = ssm_dims(cfg)
    nh, hp, N, L = dims["nh"], dims["hp"], dims["N"], cfg.ssm.chunk_size
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, S in ((1, 1024), (2, 700), (1, 16)):
            args = ssd_inputs(gen, rnd, b, S, nh, hp, N, dtype)
            (y, h), (yw, hw) = ssd_scan(*args, chunk=L), ssd_chunked(*args, L)
            what = f"b{b} S{S} nh{nh} hp{hp} N{N} L{L} {str(dtype)[6:]}"
            err = max(err, compare("ssd_scan", y, yw, dtype, f"y {what}"))
            compare("ssd_scan", h, hw, torch.float32, f"state {what}")
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:79",
                library_call="none: no single PyTorch call computes a "
                             "chunked SSD scan",
                **ssd_timed(gen, rnd, flush, err, nh, hp, N, L))


def quant_matmul_kernel(cfg, gen, rnd, compare, flush):
    """The int8-weight matmul at minicpm-2b's widths (K 2304, N 17280 =
    3 d_ff, the N the tuner recovers from the int8 FFN bytes), at the
    decode rows (4 slots) and a 1024-token prefill, plus a ragged T 37,
    K 2300, N 1000 (N % 16 != 0: the kernel's scalar weight loads).
    Column 0 of every weight is zero (scale 0). x is scaled by 1/sqrt(K),
    so outputs are of order 1. Timed in bf16 at both row counts."""
    import torch
    from repro_torch.kernels.quant import (quant_matmul, quant_matmul_plain,
                                           quantize_channels)

    dev = torch.device("cuda")
    K, N = cfg.d_model, 3 * cfg.d_ff

    def case(T, K, N, dtype):
        x = (torch.randn(T, K, generator=gen, device=dev) / K ** 0.5) \
            .to(dtype)
        w = torch.randn(K, N, generator=gen, device=dev)
        w[:, 0] = 0.0
        w_q, scale = quantize_channels(w)
        return x, w_q, scale

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for T, k, n, label in ((4, K, N, "decode"), (1024, K, N, "prefill"),
                               (37, 2300, 1000, "ragged")):
            x, w_q, scale = case(T, k, n, dtype)
            got = quant_matmul(x, w_q, scale)
            check(not bool(got[:, 0].any()), "quant_matmul: zero-scale "
                  "column is not zero")
            err = max(err, compare(
                "quant_matmul", got, quant_matmul_plain(x, w_q, scale),
                dtype, f"{label} T{T} K{k} N{n} {str(dtype)[6:]}"))

    def timed(T):
        x, w_q, scale = case(T, K, N, torch.bfloat16)
        w_deq = w_q.to(torch.bfloat16)          # exact for -127..127
        sc = scale.to(torch.bfloat16)
        nbytes = 2 * T * K + K * N + 4 * N + 2 * T * N
        b_ms, b_by = bound(nbytes, 2 * T * K * N, "bf16_tensor")
        return dict(max_abs_err=err,
                    ms=time_ms(lambda: quant_matmul(x, w_q, scale),
                               flush=flush),
                    plain_ms=time_ms(lambda: quant_matmul_plain(x, w_q, scale),
                                     flush=flush),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=time_ms(lambda: torch.matmul(x, w_deq) * sc,
                                       flush=flush),
                    body=MMA if T > 16 else "f32 CUDA cores",
                    shape=f"T{T} K{K} N{N} x bf16, w int8 + f32 scales")

    dec, pre = timed(4), timed(1024)
    return dict(name="quant_matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/quant_matmul.cu",
                replaces="src/repro/kernels/quant.py:132",
                library_call="torch.matmul against the weight dequantized "
                             "to bf16 beforehand (not timed), then the "
                             "scale", mma=MMA,
                prefill={k: pre[k] for k in SUB_KEYS if k in pre}, **dec)


def decode_variants(cfg, gen, rnd, compare, flush, mask):
    """The paged, int8 and int8-paged split-KV decode kernels at the
    full-width decode shapes: a 257-page pool whose table is a seeded
    permutation of pages 1..256, so the addressing is scattered."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        gather_pages, paged_decode_attention, paged_decode_attention_plain)
    from repro_torch.kernels.quant import (
        dequantize_rows, quant_decode_attention,
        quant_decode_attention_plain, quant_paged_decode_attention,
        quant_paged_decode_attention_plain, quantize_rows)

    dev = mask.device
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, W = mask.shape
    ps, NP = PAGE_SIZE, PAGES_PER_SEQ
    P = B * NP + 1
    pt = (torch.randperm(P - 1, generator=gen, device=dev) + 1) \
        .reshape(B, NP).to(torch.int32)
    ar = torch.arange(NP * ps, device=dev)[None, :]
    pmask = (ar <= torch.tensor(DECODE_POS, device=dev)[:, None]) & (ar < W)
    check(torch.equal(pmask, mask), "paged mask != contiguous mask")

    def int8_rows(*shape):
        return quantize_rows(torch.randn(*shape, generator=gen, device=dev))

    kq, ks = int8_rows(B, W, Hkv, D)
    vq, vs = int8_rows(B, W, Hkv, D)
    kpq, kps = int8_rows(P, ps, Hkv, D)
    vpq, vps = int8_rows(P, ps, Hkv, D)
    for dtype in (torch.float32, torch.bfloat16):
        q = rnd(B, H, D, dtype=dtype)
        kp, vp = rnd(P, ps, Hkv, D, dtype=dtype), rnd(P, ps, Hkv, D,
                                                     dtype=dtype)
        paged, tail = f"B{B} NP{NP} ps{ps} H{H} D{D}", str(dtype)[6:]
        errs = [
            compare("paged_decode", paged_decode_attention(
                q, kp, vp, pt, mask), paged_decode_attention_plain(
                q, kp, vp, pt, mask), dtype, f"{paged} {tail}"),
            compare("quant_decode", quant_decode_attention(
                q, kq, vq, ks, vs, mask), quant_decode_attention_plain(
                q, kq, vq, ks, vs, mask), dtype,
                f"B{B} W{W} H{H} D{D} int8 KV, q {tail}"),
            compare("quant_paged", quant_paged_decode_attention(
                q, kpq, vpq, kps, vps, pt, mask),
                quant_paged_decode_attention_plain(
                q, kpq, vpq, kps, vps, pt, mask), dtype,
                f"{paged} int8 KV, q {tail}")]

    valid = int(mask.sum())
    io = 2 * (2 * q.numel()) + mask.numel()        # q in, out, mask
    ops = 4 * D * H * valid
    by_bf16 = 2 * valid * Hkv * D * 2
    by_int8 = 2 * valid * Hkv * (D + 2)
    m4 = mask[:, None, None, :]

    def sdpa(k, v):
        q4 = q[:, :, None, :]
        k4, v4 = k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, enable_gqa=True)

    def deq(x, s):
        return dequantize_rows(x, s).to(torch.bfloat16)

    lib_paged = sdpa(gather_pages(kp, pt), gather_pages(vp, pt))
    lib_quant = sdpa(deq(kq, ks), deq(vq, vs))
    lib_qpaged = sdpa(deq(gather_pages(kpq, pt), gather_pages(kps, pt)),
                      deq(gather_pages(vpq, pt), gather_pages(vps, pt)))
    rows = [
        ("paged_decode_attention", "paged_attention.cu",
         "src/repro/kernels/paged_attention.py:66", errs[0],
         lambda: paged_decode_attention(q, kp, vp, pt, mask),
         lambda: paged_decode_attention_plain(q, kp, vp, pt, mask),
         by_bf16 + io + pt.numel() * 4, "bf16_tensor", lib_paged,
         "SDPA over pre-gathered bf16 K/V, gather not timed",
         f"B{B} NP{NP} ps{ps} Hq{H} Hkv{Hkv} D{D} bf16, {P}-page pool, "
         f"{valid} valid rows"),
        ("quant_decode_attention", "quant_attention.cu",
         "src/repro/kernels/quant.py:184", errs[1],
         lambda: quant_decode_attention(q, kq, vq, ks, vs, mask),
         lambda: quant_decode_attention_plain(q, kq, vq, ks, vs, mask),
         by_int8 + io, "int8_tensor", lib_quant,
         "SDPA over pre-dequantized bf16 K/V, dequantize not timed",
         f"B{B} W{W} Hq{H} Hkv{Hkv} D{D} int8 KV + bf16 scales, q bf16, "
         f"{valid} valid rows"),
        ("quant_paged_decode_attention", "quant_paged_attention.cu",
         "src/repro/kernels/quant.py:282", errs[2],
         lambda: quant_paged_decode_attention(q, kpq, vpq, kps, vps, pt,
                                              mask),
         lambda: quant_paged_decode_attention_plain(q, kpq, vpq, kps, vps,
                                                    pt, mask),
         by_int8 + io + pt.numel() * 4, "int8_tensor", lib_qpaged,
         "SDPA over pre-gathered, pre-dequantized bf16 K/V, not timed",
         f"B{B} NP{NP} ps{ps} Hq{H} Hkv{Hkv} D{D} int8 KV + bf16 scales, "
         f"q bf16, {P}-page pool, {valid} valid rows"),
    ]
    entries = {}
    for name, src, replaces, err, fn, plain, nbytes, peak, lib, lib_what, \
            shape in rows:
        b_ms, b_by = bound(nbytes, ops, peak)
        entries[name] = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            max_abs_err=err, ms=time_ms(fn, flush=flush),
            plain_ms=time_ms(plain, flush=flush), bound_ms=b_ms,
            bound_by=b_by, library_ms=time_ms(lib, flush=flush),
            library_call=lib_what, shape=shape, body=ROW_BODY)
    return entries


def paged_equals_contiguous(cfg, gen, mask):
    """At ``cfg``'s heads, the paged split-KV kernels (bf16 and int8 KV)
    give the contiguous kernels' outputs on the same rows bit for bit:
    the pool's pages are a seeded permutation, the contiguous caches
    their gather."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import (gather_pages,
                                                     paged_decode_attention)
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_paged_decode_attention,
                                           quantize_rows)

    dev = mask.device
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = mask.shape[0]
    P = B * PAGES_PER_SEQ + 1
    pt = (torch.randperm(P - 1, generator=gen, device=dev) + 1) \
        .reshape(B, PAGES_PER_SEQ).to(torch.int32)
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    pools = [torch.randn(P, PAGE_SIZE, Hkv, D, generator=gen, device=dev)
             for _ in range(2)]
    kp, vp = (t.bfloat16() for t in pools)
    (kq, ks), (vq, vs) = (quantize_rows(t) for t in pools)

    def rows(t):
        return gather_pages(t, pt).contiguous()

    same = [torch.equal(paged_decode_attention(q, kp, vp, pt, mask),
                        decode_attention(q, rows(kp), rows(vp), mask)),
            torch.equal(quant_paged_decode_attention(q, kq, vq, ks, vs, pt,
                                                     mask),
                        quant_decode_attention(q, rows(kq), rows(vq),
                                               rows(ks), rows(vs), mask))]
    check(all(same), f"D {D}: paged != contiguous (bf16, int8): {same}")
    print(f"[kernels] split-KV D{D} H{H}: paged == contiguous bit for bit, "
          f"bf16 and int8 KV ok")


def rmsnorm_bit_for_bit(gen, rnd, widths):
    """RMSNorm equal to its plain version bit for bit at each width of
    ``widths`` ({d: row counts}), f32 and bf16: stablelm-12b's qk-norm
    (d 160; a decode step's 128 query rows, a prefill's 32,768),
    qwen2-vl-7b's d_model 3584 and chatglm3-6b's 4096."""
    import torch
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    dev = torch.device("cuda")
    for d, counts in widths.items():
        s = torch.randn(d, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for rows in counts:
                x = rnd(rows, d, dtype=dtype)
                check(torch.equal(rmsnorm(x, s), rmsnorm_plain(x, s)),
                      f"rmsnorm ({rows}, {d}) {dtype}: not bit for bit")
        print(f"[kernels] rmsnorm d {d} ({', '.join(map(str, counts))} "
              f"rows, f32 and bf16): equal to the plain version bit for "
              f"bit ok")


def bit_for_bit_at(cfg, gen, rnd):
    """Flash at ``cfg``'s heads (the parity prefill and a 1024-token one),
    RMSNorm at its widths (d_model and the Mamba-2 gated norm's d_inner;
    decode and prefill rows) and the SSD scan at its widths, each equal
    to its plain version bit for bit, bf16 and f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    from repro_torch.models.ssm import ssm_dims

    dev = torch.device("cuda")
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for dtype in (torch.float32, torch.bfloat16):
        for B, S in ((2, 300), (1, 1024)):
            q, k, v = (rnd(B, S, h, D, dtype=dtype) for h in (H, Hkv, Hkv))
            check(torch.equal(flash_attention(q, k, v),
                              flash_attention_plain(q, k, v)),
                  f"flash_attention B{B} S{S} D{D} {dtype}: not bit for bit")
    print(f"[kernels] flash_attention H{H} D{D} (B2 S300, B1 S1024, f32 and "
          f"bf16): equal to the plain version bit for bit ok")
    dims = ssm_dims(cfg)
    for d in (cfg.d_model, dims["di"]):
        s = torch.randn(d, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for rows in (4, 2048):
                x = rnd(rows, d, dtype=dtype)
                check(torch.equal(rmsnorm(x, s), rmsnorm_plain(x, s)),
                      f"rmsnorm ({rows}, {d}) {dtype}: not bit for bit")
        print(f"[kernels] rmsnorm d {d} (4 and 2048 rows, f32 and bf16): "
              f"equal to the plain version bit for bit ok")
    nh, hp, N, L = dims["nh"], dims["hp"], dims["N"], cfg.ssm.chunk_size
    for dtype in (torch.float32, torch.bfloat16):
        for b, S in ((1, 1024), (2, 700)):
            x = rnd(b, S, nh, hp, dtype=dtype)
            dt = F.softplus(torch.randn(b, S, nh, generator=gen, device=dev)
                            - 2.0)
            A = -torch.exp(torch.randn(nh, generator=gen, device=dev) * 0.5)
            B, C = (rnd(b, S, nh, N, dtype=dtype) for _ in range(2))
            (y, h), (yw, hw) = (ssd_scan(x, dt, A, B, C, chunk=L),
                                ssd_chunked(x, dt, A, B, C, L))
            check(torch.equal(y, yw) and torch.equal(h, hw),
                  f"ssd_scan b{b} S{S} N{N} {dtype}: not bit for bit")
    print(f"[kernels] ssd_scan nh{nh} hp{hp} N{N} L{L} (b1 S1024, b2 S700, "
          f"f32 and bf16): equal to the plain version bit for bit ok")


# ===========================================================================
# Phase 2b: the tuner and the measured model
# ===========================================================================
# ===========================================================================
# Phase 2b: the static kernel validator on the card host
# ===========================================================================
#: The ``[validator]`` phase's budget of wall time.
VALIDATOR_BUDGET_S = 120.0
#: Served shapes the h100 tune preset does not reach, whose plans are held
#: to the library's and whose kernels' attributes are read too: flash at
#: D 80 (the chunked body; zamba2-2.7b's prefill, hubert-xlarge's
#: forward), split-KV at G 12 and 16 and D
#: 160, RMSNorm at zamba2's gated width (the wide body) and at 4 rows.
VALIDATOR_EXTRA = (
    ("prefill_attention", "zamba2-2.7b flash D 80",
     ((1, 1024, 32, 80), (1, 1024, 32, 80), (1, 1024, 32, 80)),
     {"causal": True, "window": 0}),
    ("prefill_attention", "hubert-xlarge flash D 80",
     ((2, 1024, 16, 80), (2, 1024, 16, 80), (2, 1024, 16, 80)),
     {"causal": False, "window": 0}),
    ("decode_attention", "starcoder2-3b split-KV G 12",
     ((4, 24, 128), (4, 1024, 2, 128), (4, 1024, 2, 128), (4, 1024)), {}),
    ("paged_decode_attention", "chatglm3-6b paged split-KV G 16",
     ((4, 32, 128), (257, 16, 2, 128), (257, 16, 2, 128), (4, 64),
      (4, 1024)), {}),
    ("quant_decode_attention", "stablelm-12b int8 split-KV D 160",
     ((4, 32, 160), (4, 1024, 8, 160), (4, 1024, 8, 160), (4, 1024, 8),
      (4, 1024, 8), (4, 1024)), {}),
    ("rmsnorm", "zamba2-2.7b gated norm d 5120", ((2048, 5120), (5120,)),
     {}),
    ("rmsnorm", "minicpm-2b decode rows", ((4, 2304), (2304,)), {}),
    # the served bf16 bodies the tuner's f32 cases do not run
    ("prefill_attention", "minicpm-2b flash bf16 (tensor cores)",
     ((1, 1024, 36, 64), (1, 1024, 36, 64), (1, 1024, 36, 64)),
     {"causal": True, "window": 0}),
    ("prefill_attention", "stablelm-12b flash D 160 bf16",
     ((1, 1024, 32, 160), (1, 1024, 8, 160), (1, 1024, 8, 160)),
     {"causal": True, "window": 0}),
    ("moe_gemm", "qwen2-moe-a2.7b prefill rows bf16 (tensor cores)",
     ((4096, 2048), (60, 2048, 1408), (4096,)), {"n_experts": 60}),
    ("quant_matmul", "minicpm-2b int8 matmul bf16, decode rows",
     ((4, 2304), (2304, 5760), (5760,)), {}),
    ("quant_matmul", "minicpm-2b int8 matmul bf16, prefill rows",
     ((1024, 2304), (2304, 5760), (5760,)), {}),
    ("ssd_scan", "mamba2-1.3b scan bf16",
     ((1, 1024, 64, 64), (1, 1024, 64), (64,), (1, 1024, 64, 128),
      (1, 1024, 64, 128)), {"chunk": 256}),
)
#: The port's kernels, as compute-sanitizer --kernel-name filters (a
#: kernel whose name holds one of these substrings is checked).
SANITIZE_KERNELS = ("rmsnorm", "flash_fwd", "split_rows", "quant_split",
                    "merge_kernel", "moe_gemm", "ssd_", "quant_matmul")
SANITIZE_TOOLS = ("memcheck", "racecheck", "initcheck")


def extra_meta_args(op, shapes):
    """Meta operands of a VALIDATOR_EXTRA entry in the dtypes its op
    takes (bf16 activations and weights, int8 caches and weights with
    their scales, int32 tables and routes, bool masks, f32 norm scales
    and the scan's dt and A)."""
    import torch
    dtypes = {
        "prefill_attention": (torch.bfloat16,) * 3,
        "decode_attention": (torch.bfloat16,) * 3 + (torch.bool,),
        "paged_decode_attention": (torch.bfloat16,) * 3
        + (torch.int32, torch.bool),
        "quant_decode_attention": (torch.bfloat16, torch.int8, torch.int8,
                                   torch.bfloat16, torch.bfloat16,
                                   torch.bool),
        "rmsnorm": (torch.bfloat16, torch.float32),
        "moe_gemm": (torch.bfloat16, torch.bfloat16, torch.int32),
        "quant_matmul": (torch.bfloat16, torch.int8, torch.float32),
        "ssd_scan": (torch.bfloat16, torch.float32, torch.float32,
                     torch.bfloat16, torch.bfloat16)}[op]
    return tuple(torch.empty(sh, dtype=dt, device="meta")
                 for sh, dt in zip(shapes, dtypes))


def sanitizer_runs(env):
    """compute-sanitizer's three tools over ``kernel_validator
    --sanitize``, filtered to the port's kernels. Where the toolkit lacks
    the tool, or the tool refuses the card, says so on a line of its
    own; where it runs, every tool must report no error."""
    import os
    import shutil
    tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/" \
        "compute-sanitizer"
    if not os.path.exists(tool):
        print("[validator] compute-sanitizer: not in this CUDA toolkit "
              "(looked on PATH and in /usr/local/cuda/bin); memcheck, "
              "racecheck and initcheck not run")
        return "absent"
    version = subprocess.run([tool, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    version = version.splitlines()[-1] if version else "unknown version"
    target = [sys.executable, "-m", "repro_torch.analysis.kernel_validator",
              "--sanitize"]
    for name in SANITIZE_TOOLS:
        run_env = dict(env)
        if name == "initcheck":
            run_env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
        t0 = time.perf_counter()
        filters = [a for k in SANITIZE_KERNELS
                   for a in ("--kernel-name", f"kns={k}")]
        r = subprocess.run([tool, "--tool", name, *filters, *target],
                           capture_output=True, text=True, timeout=600,
                           env=run_env, cwd=ROOT)
        out = r.stdout + r.stderr
        if "Device not supported" in out:
            print(f"[validator] compute-sanitizer ({version}) is in the "
                  f"toolkit but refuses this card under --tool {name}: "
                  f"\"Error: Device not supported\" (rc {r.returncode}, "
                  f"{time.perf_counter() - t0:.1f} s); memcheck, racecheck "
                  f"and initcheck cannot run here")
            return "refused"
        summary = [line for line in out.splitlines()
                   if "SUMMARY" in line]
        print(f"[validator] compute-sanitizer --tool {name}: rc "
              f"{r.returncode}, {summary[-1] if summary else 'no summary'} "
              f"({time.perf_counter() - t0:.1f} s)")
        check(r.returncode == 0 and summary and (
            " 0 errors" in summary[-1] or " 0 hazards" in summary[-1]),
            f"compute-sanitizer --tool {name}: {out[-3000:]}")
    return "ran"


def validator_phase():
    """``[validator]``: the static kernel validator over the h100 tune
    grid; every plan of every case x grid point equal to the library's
    plan export (name, grid, block, dynamic shared memory), and so the
    extra served shapes' (VALIDATOR_EXTRA); each case launched once
    through its wrapper, its outputs' shapes and dtypes the plan's; per
    kernel symbol its registers, static and dynamic shared memory and
    blocks an SM within the card's limits (static shared memory equal to
    the plan's); compute-sanitizer where it runs; then every kernel once
    more with its buffers poisoned (``kernel_validator --sanitize``).
    Returns the phase's findings count."""
    import os
    import torch
    from repro_torch.analysis.kernel_validator import (check_plan,
                                                       mesh_cases,
                                                       validate_mesh_cases,
                                                       validate_preset)
    from repro_torch.kernels import plan as P
    from repro_torch.kernels import tune
    from repro_torch.kernels.dispatch import implementations

    t0 = time.perf_counter()
    preset = tune.H100
    findings = validate_preset(preset) + validate_mesh_cases()
    for f in findings:
        print(f"[validator] {f.describe()}")
    errors = sum(f.severity == "error" for f in findings)
    print(f"[validator] static pass over the {preset.name} grid and the "
          f"mesh shapes: {len(findings)} findings, {errors} errors "
          f"({time.perf_counter() - t0:.1f} s)")
    check(errors == 0, f"kernel validator: {errors} errors")

    lib_launches = {}            # kernel -> [(plan launch, library launch)]

    def against_library(label, fn, args, kw):
        plan = fn.launch_plan(*args, **kw)
        lib = fn.library_plan(*args, **kw)
        check(plan.geometry() == [x.geometry() for x in lib],
              f"{label}: plan {plan.geometry()} != library "
              f"{[x.geometry() for x in lib]}")
        for mine, theirs in zip(plan.launches, lib):
            lib_launches.setdefault(mine.kernel, []).append((mine, theirs))
        return plan

    n_plans = n_calls = 0
    for arch, shape in preset.cells:
        for case in tune.cases_for_cell(preset.arch(arch),
                                        preset.shape(shape),
                                        bench_batch=preset.bench_batch,
                                        page_sizes=preset.paged_page_sizes,
                                        device="meta"):
            fn = implementations(case.op)["cuda"]
            for params in preset.grid(case.op, "cuda"):
                kw = {**case.kwargs, **params}
                against_library(f"{arch}/{shape} {case.op} {params}", fn,
                                case.make_args(), kw)
                n_plans += 1
        # each case once through its wrapper, on the card
        for case in tune.cases_for_cell(preset.arch(arch),
                                        preset.shape(shape),
                                        bench_batch=preset.bench_batch,
                                        page_sizes=preset.paged_page_sizes,
                                        device="cuda"):
            fn = implementations(case.op)["cuda"]
            args = case.make_args()
            for params in preset.grid(case.op, "cuda"):
                kw = {**case.kwargs, **params}
                plan = fn.launch_plan(*args, **kw)   # the real routing
                for launch in plan.launches:
                    bad = check_plan(launch, label=f"{arch}/{shape}")
                    check(not bad, f"{case.op} real plan: "
                          f"{[f.describe() for f in bad]}")
                out = fn(*args, **kw)
                outs = out if isinstance(out, tuple) else (out,)
                got = [(tuple(t.shape), t.dtype) for t in outs]
                want = [(tuple(sh), dt) for sh, dt in plan.results]
                check(got == want, f"{arch}/{shape} {case.op}: outputs "
                      f"{got} != planned {want}")
                n_calls += 1
            del args
        torch.cuda.synchronize()
    for op, label, shapes, kw in VALIDATOR_EXTRA:
        against_library(label, implementations(op)["cuda"],
                        extra_meta_args(op, shapes), kw)
        n_plans += 1
    # the per-rank shapes of the mesh forms (the [kernels] phase ran each
    # against its plain version): planned as the library plans them
    for op, label, args, kw in mesh_cases():
        against_library(label, implementations(op)["cuda"], args, kw)
        n_plans += 1
    print(f"[validator] {n_plans} plans == the library's plans (name, "
          f"grid, block, dynamic smem); {n_calls} wrapper calls, outputs "
          f"== planned shapes and dtypes")

    mismatched = []
    for kernel, pairs in sorted(lib_launches.items()):
        mine, theirs = max(pairs, key=lambda p: p[1].smem_dynamic)
        a = P.kernel_attributes(theirs)
        threads = int(math.prod(theirs.block))
        dyn = theirs.smem_dynamic
        print(f"[validator] {kernel:<44} registers {a['registers']:3d} "
              f"static smem {a['smem_static']:6d} B dynamic smem {dyn:6d} B "
              f"local {a['local_bytes']:3d} B threads {threads:4d} blocks/SM "
              f"{a['blocks_per_sm']:2d}")
        check(a["smem_static"] + dyn <= a["smem_optin"],
              f"{kernel}: {a['smem_static']} + {dyn} B of shared memory > "
              f"{a['smem_optin']}")
        check(a["registers"] * threads <= P.REGISTERS_PER_SM,
              f"{kernel}: {a['registers']} registers x {threads} threads")
        check(a["blocks_per_sm"] >= 1, f"{kernel}: no block fits an SM")
        if mine.smem_static != a["smem_static"]:
            mismatched.append((kernel, mine.smem_static, a["smem_static"]))
    check(not mismatched, f"plan static smem != the kernels': {mismatched}")
    print(f"[validator] {len(lib_launches)} kernels within the card's "
          f"limits ({a['smem_optin']} B of shared memory a block, "
          f"{P.REGISTERS_PER_SM} registers an SM, {a['sms']} SMs); static "
          f"smem == planned for each")

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    state = sanitizer_runs(env)
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.analysis.kernel_validator",
                        "--sanitize"], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    for line in r.stdout.splitlines():
        print(f"[validator] {line}")
    check(r.returncode == 0, f"kernel_validator --sanitize: rc "
          f"{r.returncode}\n{r.stdout[-2000:]}{r.stderr[-3000:]}")
    print(f"[validator] poisoned run: every kernel once, f32 and bf16, "
          f"outputs == plain ({time.perf_counter() - t1:.1f} s); "
          f"compute-sanitizer: {state}")
    dt = time.perf_counter() - t0
    print(f"[validator] phase {dt:.1f} s (budget {VALIDATOR_BUDGET_S:.0f} s)")
    check(dt <= VALIDATOR_BUDGET_S, f"validator phase took {dt:.1f} s")
    return len(findings)


#: Batch, ``max_len`` and page size of the h100 preset's traces
#: (``analysis.registry.PRESETS["h100"]``), at which the traced decode
#: step's kernel nodes are tied to one eager step's launches.
GRAPH_BATCH = 2


def graph_start():
    """``[graph]``, started: the ``h100`` preset of ``graph_lint`` on the
    card's host, the eight ``H100_ARCHS`` at full width, ``max_len``
    4096, page 16, traced on ``meta`` under the cuda policy (nothing
    allocated, nothing launched), one arch a worker process (forked from
    the forkserver the meshes use). The workers trace while the caller
    goes on (``[validator]``); :func:`graph_phase` collects them."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from repro_torch.analysis.graph_lint import lint_summary
    from repro_torch.analysis.registry import PRESETS
    from repro_torch.launch.mesh import FORKSERVER_PRELOAD

    p = PRESETS["h100"]
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(FORKSERVER_PRELOAD))
    # a core left to the caller
    workers = max(1, min(len(p.archs), (os.cpu_count() or 2) - 1))
    ex = ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                             initializer=torch.set_num_threads,
                             initargs=(1,))
    futures = {a: ex.submit(lint_summary, a, p.max_len, p.page_size,
                            p.smoke) for a in p.archs}
    return ex, futures, workers, time.perf_counter()


def graph_phase(started):
    """``[graph]``'s results (:func:`graph_start`): per arch its labels,
    its findings by rule and severity and the kernel nodes of one decode
    step; fails on an error or a warning. Returns {arch: {label: kernel
    nodes}}. The workers go on with ``[dryrun]``'s traces
    (:func:`dryrun_phase` shuts them down)."""
    from collections import Counter
    from repro_torch.analysis.registry import PRESETS
    ex, futures, workers, t0 = started
    results = {a: f.result() for a, f in futures.items()}
    p = PRESETS["h100"]
    nodes = {}
    for arch, r in results.items():
        counts = Counter(f"{f.rule_id}/{f.severity}" for f in r["findings"])
        bad = [f.describe() for f in r["findings"]
               if f.severity in ("error", "warning")]
        labels = sorted(r["kernels"])
        steps = [lab.split("/")[0] + lab.partition(arch)[2] for lab in labels
                 if not lab.startswith("prefill/")]
        lengths = sorted(int(lab.rpartition("@L")[2]) for lab in labels
                         if lab.startswith("prefill/"))
        print(f"[graph] {arch}: {len(labels)} labels ({', '.join(steps)}; "
              f"prefill at L {lengths}); findings "
              f"{dict(counts) or 'none'}; decode_step kernel nodes "
              f"{r['kernels'][f'decode_step/{arch}']}; "
              f"{r['seconds']:.1f} s")
        check(not bad, f"[graph] {arch}: {bad}")
        nodes[arch] = r["kernels"]
    print(f"[graph] h100 preset ({len(p.archs)} archs, max_len "
          f"{p.max_len}, page {p.page_size}, batch {GRAPH_BATCH}): no error"
          f" or warning; {workers} workers beside [validator], "
          f"{time.perf_counter() - t0:.1f} s from their start")
    return nodes


def graph_launches(label, cfg, params, rt, counters, cases):
    """One eager decode step on the card per case ``(kv_dtype, paged)``
    at the h100 preset's shapes (batch 2, ``max_len`` 4096, page 16; a
    zero cache, every slot at position 0): each wrapper's launches over
    the step, its count set to 0 just before, equal to the kernel nodes
    of the same step traced on ``meta`` (``graph_lint.decode_kernels``).
    Returns the launches summed over the cases."""
    import dataclasses
    import torch
    from repro_torch.analysis.graph_lint import decode_case, decode_kernels
    from repro_torch.analysis.registry import PRESETS
    p = PRESETS["h100"]
    total = {k: 0 for k in counters}
    for kv, paged in cases:
        crt = dataclasses.replace(rt, kv_dtype=kv)
        ps = p.page_size if paged else None
        t0 = time.perf_counter()
        traced = decode_kernels(cfg, crt, batch=GRAPH_BATCH,
                                max_len=p.max_len, page_size=ps)
        t_trace = time.perf_counter() - t0
        fn, spec, _ = decode_case(cfg, crt, batch=GRAPH_BATCH,
                                  max_len=p.max_len, page_size=ps)
        cache = {k: torch.zeros(s, dtype=d, device="cuda")
                 for k, (s, d) in spec.items()}
        tokens = torch.zeros((GRAPH_BATCH,), dtype=torch.int32,
                             device="cuda")
        for c in counters.values():
            c.launches = 0
        with torch.no_grad():
            _, logits = fn(params, cache, tokens)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in counters.items()}
        check(bool(logits.isfinite().all()), f"[graph] {label}: logits")
        name = f"{'paged' if paged else 'contiguous'} {kv or rt.dtype}"
        print(f"[graph] {label} {name}: traced kernel nodes "
              f"{dict(traced)} (meta, {t_trace:.1f} s) == launches of one "
              f"decode step on the card "
              f"{ {k: n for k, n in launched.items() if n} }")
        check({k: n for k, n in launched.items() if n} == dict(traced),
              f"[graph] {label} {name}: traced {dict(traced)}, launched "
              f"{launched}")
        for k, n in launched.items():
            total[k] += n
        del cache, logits
    return total


def tune_close(op, got, want):
    """The tuner's cuda output against its torch output (TUNE_TOL);
    returns max |err| over the output's RMS."""
    import torch
    tol = TUNE_TOL.get(op, F32_TOL)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        g, w = g.float(), w.float()
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"{op}: shape {tuple(g.shape)} vs {tuple(w.shape)}, or "
              f"non-finite")
        rms = max(1.0, float(w.square().mean().sqrt()))
        torch.testing.assert_close(g, w, atol=tol["atol"] * rms,
                                   rtol=tol["rtol"],
                                   msg=lambda m: f"tuner {op}: {m}")
        worst = max(worst, float((g - w).abs().max()) / rms)
    return worst


def tuner_phase(counters):
    """``run_tuning(h100, reps=3)`` on the card, written under
    chiprun_out/: every op timed under torch and cuda, every kernel
    launched, cuda == torch on every case (checked once, after the
    timing, on the same seeded inputs), the calibrated policy, the
    measured model of every cell and the roofline-vs-measured rows.
    Returns the phase's launch counts."""
    import os
    import torch
    from repro_torch.bench import kernel_model_error
    from repro_torch.core.analytical import DesignPoint, MeasuredModel
    from repro_torch.core.workload import lm_workload
    from repro_torch.kernels import tune
    from repro_torch.kernels.dispatch import (KERNEL_OPS, KernelPolicy,
                                              implementations)

    out_dir = ROOT / "chiprun_out"
    os.environ.setdefault("REPRO_TORCH_ARTIFACT_DIR",
                          str(out_dir / "artifacts"))
    t0 = time.perf_counter()
    preset = tune.H100
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    payload = tune.run_tuning(preset, reps=3, validate=True, device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    t_tune = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[tune] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
          f"{total / 2**30:.1f}")
    path = tune.write_calibration(payload, str(out_dir /
                                               "calibration_h100.json"))
    print(f"[tune] {len(payload['entries'])} entries in {t_tune:.1f} s -> "
          f"{Path(path).relative_to(ROOT)} ({payload['timer']}; "
          f"{payload['device']})")
    print(f"[tune] launches {launches}")
    print(f"[tune] validation {payload['validation']}")
    check(payload["validation"] is not None
          and payload["validation"]["errors"] == 0,
          f"tuner validation: {payload['validation']}")
    for name, n in launches.items():
        check(n > 0, f"tuner: kernel {name} was not launched")
    entries = payload["entries"]
    check({e["op"] for e in entries} == set(KERNEL_OPS),
          f"tuner: ops {sorted({e['op'] for e in entries})}")
    for e in entries:
        check(set(e["impls"]) == {"torch", "cuda"},
              f"tuner {e['op']}: impls {sorted(e['impls'])}")
        t, c = e["impls"]["torch"], e["impls"]["cuda"]
        print(f"[tune] {e['arch']}/{e['shape']} {e['op']:<28} torch "
              f"{t['best_s'] * 1e3:10.4f} ms {t['best_params'] or ''} cuda "
              f"{c['best_s'] * 1e3:10.4f} ms {c['best_params'] or ''} -> "
              f"{e['winner']}")

    # cuda == torch on each case, on the inputs the case timed
    for arch, shape in preset.cells:
        for case in tune.cases_for_cell(preset.arch(arch),
                                        preset.shape(shape),
                                        bench_batch=preset.bench_batch,
                                        page_sizes=preset.paged_page_sizes,
                                        device="cuda"):
            args = case.make_args()
            impls = implementations(case.op)
            err = tune_close(case.op, impls["cuda"](*args, **case.kwargs),
                             impls["torch"](*args, **case.kwargs))
            print(f"[tune] check {arch}/{shape} {case.op}: max|cuda - torch| "
                  f"/ max(1, rms) {err:.3e} ok")
            del args
    gc.collect()
    torch.cuda.empty_cache()

    pol = KernelPolicy.from_calibration(payload)
    for op, choice in payload["policy"].items():
        check(pol.impl_for(op) == choice["impl"]
              and pol.params_for(op) == choice["params"],
              f"from_calibration {op}: {pol.impl_for(op)} "
              f"{pol.params_for(op)} vs {choice}")
    print(f"[tune] policy: {pol.describe()}; params {dict(pol.params)}")

    for arch, shape in preset.cells:
        wl = lm_workload(preset.arch(arch), preset.shape(shape))
        r = MeasuredModel(wl, payload, chip=H100_SXM).evaluate(
            DesignPoint.make())
        check(r.feasible and r.latency_s > 0, f"MeasuredModel {wl.name}: "
              f"{r.reason}")
        measured = int(r.resources["measured_ops"])
        interp = int(r.resources["interpolated_ops"])
        # the h100 preset times one sequence per case and the cells run at
        # their global batch, so most ops fall outside the 4x match window
        label = ("interpolated, no forecast" if interp > measured
                 else "forecast")
        print(f"[model] {wl.name} (global batch "
              f"{preset.shape(shape).global_batch}; {label}): "
              f"{r.latency_s * 1e3:.3f} ms, {r.gops:.1f} GOP/s, efficiency "
              f"{r.efficiency:.4f} of {H100_SXM.name} bf16 peak; ops "
              f"measured {measured}, interpolated {interp}")
    err = kernel_model_error.run(payload)
    for r in err["op_rows"]:
        print(f"[model] roofline {r['arch']}/{r['shape']} {r['op']:<28} "
              f"measured {r['measured_ms']:.4f} ms ({r['winner']}), "
              f"roofline {r['roofline_ms']:.4f} ms, error {r['err_pct']:.1f} %")
    check(err["pass"], "kernel_model_error did not pass")
    print(f"[model] roofline-vs-measured error median "
          f"{err['median_err_pct']:.2f} % / mean {err['mean_err_pct']:.2f} % "
          f"over {err['ops']} entries")
    print(f"[tune] phase wall time {time.perf_counter() - t0:.1f} s")
    return launches


# ===========================================================================
# Phase 3: serving at full width
# ===========================================================================
PROMPT_LENS = (12, 700, 37, 300, 150, 64, 511, 90)
NEW_TOKENS = 32
#: Depths of the recurrent models in their serving runs (widths uncut;
#: their profiles, traces and parity stay at full depth): chunk-mode
#: admission steps every prompt token through every layer, ~350 host-
#: bound steps a run, so zamba2-2.7b's four runs and mamba2-1.3b's two
#: took 202 s of the script at 54 and 48 layers, ~100 s at 18 and 16.
#: Cut to keep the run well inside its time limit; zamba2-2.7b's 12 are
#: two groups, so both of its physical shared blocks run.
SERVE_RECURRENT_LAYERS = {"mamba2-1.3b": 8, "zamba2-2.7b": 12}
#: Shared-system-prompt trace: one 512-token prompt + tails of 8-40.
SYSTEM_LEN, N_SYSTEM_REQS = 512, 8


def drive(label, make, params, requests, counters, expect):
    """Serve ``requests`` through the engine ``make()`` builds on
    ``params``, every launch count set to 0 just before and read just
    after: the kernels in ``expect`` must have run, the other paths'
    kernels must not. The capacity model's prediction for the engine
    (``serve_preflight`` at its runtime's dtypes) must hold its
    parameters and cache to the byte; its peak is held against the
    run's (engine built, prefills and decode steps), in a
    ``[capacity]`` line. Returns the run's record."""
    import numpy as np
    import torch
    from repro_torch.analysis.capacity import serve_preflight
    from repro_torch.serve import Request

    other = peak_start(tree_bytes(params))
    eng = make()
    paged = hasattr(eng, "pages")
    rt = eng.rt
    cap = serve_preflight(eng.cfg, n_slots=eng.n_slots, max_len=eng.max_len,
                          page_size=eng.page_size if paged else None,
                          dtype=rt.dtype, param_dtype=rt.dtype,
                          kv_dtype=rt.kv_dtype)
    check(cap.params_bytes == tree_bytes(eng.params)
          and cap.cache_bytes == tree_bytes(eng.cache),
          f"{label}: predicted params {cap.params_bytes} B and cache "
          f"{cap.cache_bytes} B, allocated {tree_bytes(eng.params)} and "
          f"{tree_bytes(eng.cache)}")
    for fn in counters.values():
        fn.launches = 0
    for i, prompt in enumerate(requests):
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=NEW_TOKENS))
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        t1 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        if name in expect:
            check(n > 0, f"{label}: kernel {name} was not launched")
        else:
            check(n == 0, f"{label}: kernel {name} of another path ran "
                          f"{n} times")
    st = eng.stats
    vocab = eng.cfg.vocab_size
    check(len(eng.finished) == len(requests) and not eng.rejected,
          f"{label}: served {len(eng.finished)}/{len(requests)}, rejected "
          f"{len(eng.rejected)}")
    check(all(len(r.out_tokens) == NEW_TOKENS
              and all(0 <= t < vocab for t in r.out_tokens)
              for r in eng.finished), f"{label}: bad token streams")
    bound_c = eng.scheduler.max_prefill_compiles()
    check(st.prefill_compiles <= bound_c,
          f"{label}: prefill shapes {st.prefill_compiles} > bound {bound_c}")
    toks = sum(len(r.out_tokens) for r in eng.finished)
    p50, p99 = np.percentile(np.array(steps) * 1e3, (50, 99))
    pages = ""
    if hasattr(eng, "pages"):
        pages = (f"; pages {eng.n_pages} ({eng.pages.live_pages} live, "
                 f"{eng.pages.free_pages} free), prefix hits "
                 f"{st.prefix_hits} ({st.prefix_hit_tokens} tokens)")
    print(f"[serve] {label}: {len(eng.finished)}/{len(requests)} requests, "
          f"{toks} tokens in {dt:.3f} s ({toks / dt:.1f} tok/s); step p50 "
          f"{p50:.2f} ms p99 {p99:.2f} ms over {len(steps)} steps; max "
          f"active {st.max_active}; prefill calls {st.prefills}, "
          f"{st.prefill_tokens} tokens, shapes {st.prefill_compiles} (bound "
          f"{bound_c}); kv cache {eng.kv_cache_bytes() / 2**30:.4f} GiB"
          f"{pages}")
    print(f"[serve] {label}: launches {launches}")
    capacity_record(eng.cfg.name, "decode", "paged" if paged else
                    "contiguous", rt.kv_dtype, cap, other)
    return dict(streams={r.rid: r.out_tokens for r in eng.finished},
                launches=launches, stats=st, tok_s=toks / dt, p50_ms=p50,
                p99_ms=p99, kv_bytes=eng.kv_cache_bytes(),
                n_pages=getattr(eng, "n_pages", None))


def serve_phase(cfg, params, counters, rt):
    """Full-width serving through both engines, bf16 and int8 KV, and the
    prefix cache; ``rt`` is the bf16 ``cuda``-policy runtime."""
    import dataclasses
    import numpy as np
    from repro_torch.serve import PagedServeEngine, Scheduler, ServeEngine

    rt8 = dataclasses.replace(rt, kv_dtype="int8")
    base = {"rmsnorm", "flash_attention"}

    def engine(paged, run_rt, width=1, prefix=False):
        """A builder of the run's engine, for ``drive``."""
        kw = dict(n_slots=4, max_len=1024, scheduler=Scheduler(
            cfg=cfg, max_len=1024, admit_width=width))
        if paged:
            return lambda: PagedServeEngine(
                params, cfg, run_rt, page_size=PAGE_SIZE,
                prefix_cache=prefix, **kw)
        return lambda: ServeEngine(params, cfg, run_rt, **kw)

    def prompts(seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in PROMPT_LENS]

    runs = {}
    for width in (1, 2):
        runs[f"contiguous bf16 w{width}"] = drive(
            f"contiguous bf16, admit_width={width}",
            engine(False, rt, width), params, prompts(width), counters,
            base | {"decode_attention"})
    reqs = prompts(1)
    for label, paged, run_rt, kernel in (
            ("paged bf16", True, rt, "paged_decode_attention"),
            ("contiguous int8", False, rt8, "quant_decode_attention"),
            ("paged int8", True, rt8, "quant_paged_decode_attention")):
        runs[label] = drive(f"{label}, prefix cache off",
                            engine(paged, run_rt), params, reqs, counters,
                            base | {kernel})
        if paged:
            want = 257 if run_rt.kv_dtype is None else 497
            check(runs[label]["n_pages"] == want, f"{label}: equal-HBM "
                  f"budget {runs[label]['n_pages']} pages, expected {want}")
    contig = runs["contiguous bf16 w1"]["kv_bytes"]
    for label in ("paged bf16", "contiguous int8", "paged int8"):
        kvb = runs[label]["kv_bytes"]
        print(f"[serve] kv cache {label}: {kvb} B = {kvb / contig:.4f} x "
              f"contiguous bf16 ({contig} B)")
        # the paged pools are sized to the contiguous bf16 bytes; the
        # contiguous int8 cache simply stores fewer bytes
        check(label == "contiguous int8" or abs(kvb - contig) <= 0.01 * contig,
              f"{label}: kv cache {kvb} B is not within 1 % of {contig} B")
    check(runs["paged bf16"]["streams"]
          == runs["contiguous bf16 w1"]["streams"],
          "paged bf16 token streams differ from contiguous bf16")
    check(runs["paged int8"]["streams"] == runs["contiguous int8"]["streams"],
          "paged int8 token streams differ from contiguous int8")
    print(f"[serve] paged bf16 streams == contiguous bf16; paged int8 "
          f"streams == contiguous int8 ({len(reqs)} requests x "
          f"{NEW_TOKENS} tokens each)")

    rng = np.random.default_rng(11)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_LEN)
    shared = [np.concatenate([system, rng.integers(
        0, cfg.vocab_size, int(rng.integers(8, 41)))]).astype(np.int32)
        for _ in range(N_SYSTEM_REQS)]
    for prefix in (False, True):
        runs[f"prefix {prefix}"] = drive(
            f"shared {SYSTEM_LEN}-token prompt, paged bf16, prefix cache "
            f"{'on' if prefix else 'off'}", engine(True, rt, prefix=prefix),
            params, shared, counters, base | {"paged_decode_attention"})
    cold, warm = runs["prefix False"], runs["prefix True"]
    check(warm["stats"].prefix_hits >= 1, "prefix cache never hit")
    check(warm["stats"].prefill_tokens < cold["stats"].prefill_tokens,
          f"prefill tokens warm {warm['stats'].prefill_tokens} >= cold "
          f"{cold['stats'].prefill_tokens}")
    same = sum(a == b for rid in cold["streams"]
               for a, b in zip(cold["streams"][rid], warm["streams"][rid]))
    print(f"[serve] prefix cache: {warm['stats'].prefix_hits} hits, prefill "
          f"tokens {warm['stats'].prefill_tokens} warm vs "
          f"{cold['stats'].prefill_tokens} cold; warm tokens equal to cold "
          f"at {same}/{N_SYSTEM_REQS * NEW_TOKENS} positions (a hit "
          f"decode-feeds its tail, which rounds differently in bf16)")
    return launch_totals(runs, counters)


def launch_totals(runs, counters):
    return {name: sum(r["launches"][name] for r in runs.values())
            for name in counters}


def serve_pair(label, cfg, params, rt, counters, expect, attention,
               kv_dtypes=(None,)):
    """One trace through ``ServeEngine`` and ``PagedServeEngine`` (page
    size 16, the equal-HBM budget, prefix cache off) for each KV dtype
    of ``kv_dtypes`` (None: ``rt.dtype``; ``int8``): the same token
    streams, and each run's launch counts. ``attention`` adds the
    contiguous and the paged decode kernel of the KV dtype to the
    expected sets (a pure SSM model runs neither). A recurrent model
    must have admitted in chunk mode; the paged pools must hold the
    contiguous bf16 cache's bytes within 1 %."""
    import dataclasses
    import numpy as np
    from repro_torch.serve import PagedServeEngine, Scheduler, ServeEngine

    kw = dict(n_slots=4, max_len=1024,
              scheduler=Scheduler(cfg=cfg, max_len=1024))
    rng = np.random.default_rng(21)
    reqs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]
    runs = {}
    for kvd in kv_dtypes:
        run_rt = dataclasses.replace(rt, kv_dtype=kvd)
        tag = kvd or "bf16"
        quant = "quant_" if kvd == "int8" else ""
        for kind, make, kernel in (
                ("contiguous", lambda: ServeEngine(params, cfg, run_rt, **kw),
                 f"{quant}decode_attention"),
                ("paged", lambda: PagedServeEngine(
                    params, cfg, run_rt, page_size=PAGE_SIZE,
                    prefix_cache=False, **kw),
                 f"{quant}paged_decode_attention")):
            runs[kind, tag] = drive(
                f"{label} {kind} {tag}", make, params, reqs, counters,
                expect | ({kernel} if attention else set()))
            if cfg.family in ("ssm", "hybrid"):
                check(runs[kind, tag]["stats"].forced_tokens > 0,
                      f"{label} {kind}: no chunk-mode admission")
        check(runs["paged", tag]["streams"]
              == runs["contiguous", tag]["streams"],
              f"{label} {tag}: paged token streams differ from contiguous")
        print(f"[serve] {label}: paged {tag} streams == contiguous "
              f"({len(reqs)} requests x {NEW_TOKENS} tokens each)")
    if attention:
        contig = runs["contiguous", "bf16"]["kv_bytes"]
        for key, r in runs.items():
            print(f"[serve] kv cache {label} {key[0]} {key[1]}: "
                  f"{r['kv_bytes']} B = {r['kv_bytes'] / contig:.4f} x "
                  f"contiguous bf16")
            check(key[0] == "contiguous"
                  or abs(r["kv_bytes"] - contig) <= 0.01 * contig,
                  f"{label} {key}: kv cache {r['kv_bytes']} B is not "
                  f"within 1 % of {contig} B")
    return launch_totals(runs, counters)


def device_profile(label, step, steps=5, focus=()):
    """Wall time of ``steps`` calls of ``step`` against the device time
    of the kernels they run (torch.profiler); prints the top kernels and,
    for each name in ``focus``, the device time and launches per step of
    the kernels whose name holds it, with their share of the busy time.
    Returns the wall and device-busy ms of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()                                                # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0.0)
        if dt > 0 and ev.device_type.name == "CUDA":
            rows.append((dt / 1e3 / steps, ev.count / steps, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] {label}: {wall_ms:.2f} ms wall, {busy:.3f} ms device "
          f"busy ({busy / wall_ms:.1%}), idle share {1 - busy / wall_ms:.1%}; "
          f"{sum(r[1] for r in rows):.0f} kernels per step")
    for ms, n, key in rows[:8]:
        print(f"[profile]   {ms:8.4f} ms/step  {n:6.0f}x  {key[:90]}")
    for name in focus:
        mine = [r for r in rows if name in r[2]]
        check(bool(mine), f"{label}: no {name} kernel in the profile")
        ms = sum(r[0] for r in mine)
        print(f"[profile]   {name}: {ms:.3f} ms/step, "
              f"{sum(r[1] for r in mine):.0f} launches/step, "
              f"{ms / busy:.1%} of device busy")
    return {"wall_ms": wall_ms, "device_ms": busy}


#: Unprofiled decode steps timed for ``[explore]``'s wall: the profiler's
#: CPU-side recording about doubles a decode step's wall.
DECODE_WALL_STEPS = 5


def profile_model(label, cfg, params, rt, prefill_focus=(),
                  decode_focus=()):
    """One 1024-token prefill (wall time, then its device profile) and
    the device profile of a full-width contiguous decode step, 4 slots
    at positions 512-516, with the shares of the kernels named in
    ``prefill_focus`` and ``decode_focus`` (device_profile). Returns the
    4 prompts, their next tokens and the measurements ``[explore]`` reads:
    per phase, the unprofiled wall ms and the device-busy ms of one
    call."""
    import torch
    from repro_torch.analysis.capacity import capacity
    from repro_torch.models import decode_step, prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                             device=dev)
        prefill(params, cfg, {"tokens": toks}, 1024, rt)      # warm-up
        other = peak_start(tree_bytes(params))
        t0 = time.perf_counter()
        prefill(params, cfg, {"tokens": toks}, 1024, rt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        print(f"[profile] {label} prefill B1 S1024: {wall_ms:.2f} ms wall")
        capacity_record(cfg.name, "prefill", "prefill B1 S1024",
                        rt.kv_dtype, capacity(
                            cfg, served_shapes()["prefill"], dtype=rt.dtype,
                            kv_dtype=rt.kv_dtype), other)
        measured = {"prefill": dict(device_profile(
            f"{label} prefill B1 S1024", lambda: prefill(
                params, cfg, {"tokens": toks}, 1024, rt), steps=3,
            focus=prefill_focus), wall_ms=wall_ms)}
        toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                             device=dev)
        nxt = toks[:, -1]
        cache, _ = prefill(params, cfg, {"tokens": toks}, 1024, rt)

        def step():
            decode_step(params, cfg, cache, nxt, rt)

        pos0 = cache["pos"].clone()       # the step advances it in place
        step()                                                # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_WALL_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / DECODE_WALL_STEPS
        cache["pos"].copy_(pos0)          # the profile runs at 512-516 too
        what = f"{label} decode step B4 at pos 512-516, contiguous bf16"
        print(f"[profile] {what}: {wall_ms:.2f} ms wall, unprofiled "
              f"({DECODE_WALL_STEPS} steps)")
        measured["decode"] = dict(device_profile(what, step,
                                                 focus=decode_focus),
                                  wall_ms=wall_ms)
    return toks, nxt, measured


def profile_phase(cfg, params, rt):
    """Where a full-width minicpm-2b decode step's time goes, contiguous
    bf16 and paged int8 (4 slots at positions 512-516), plus one
    1024-token prefill. Returns profile_model's measurements."""
    import dataclasses
    import torch
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    prefill, write_prefill_pages_quant)

    dev = torch.device("cuda")
    toks, nxt, measured = profile_model(cfg.name, cfg, params, rt,
                                        decode_focus=(BF16_KERNEL,))
    held_out_prefills(cfg, params, rt)
    with torch.no_grad():
        # paged int8: each slot's 64 pages, rows written through its table
        rt8 = dataclasses.replace(rt, kv_dtype="int8")
        single, _ = prefill(params, cfg, {"tokens": toks}, 1024, rt8)
        npp = PAGES_PER_SEQ
        cache = init_paged_cache(cfg, 4, 4 * npp + 1, PAGE_SIZE, 1024,
                                 rt.dtype, "int8", device=dev)
        cache["pt"].copy_(torch.arange(1, 4 * npp + 1, device=dev)
                          .reshape(4, npp))
        write_prefill_pages_quant(
            cache["kp"], cache["vp"], cache["ks"], cache["vs"], single["k"],
            single["v"], single["ks"], single["vs"], cache["pt"],
            page_size=PAGE_SIZE)
        cache["pos"].copy_(single["pos"])
        del single
        device_profile(f"{cfg.name} decode step B4 at pos 512-516, paged "
                       f"int8", lambda: decode_step_paged(
                           params, cfg, cache, nxt, rt8,
                           page_size=PAGE_SIZE, window=1024),
                       focus=(INT8_KERNEL,))
    return measured


def served_shapes():
    """The cells ``profile_model`` runs, as the one-card model and the
    trace front-end name them: one 1024-token prefill, and a decode step
    of 4 slots against 516 cached rows."""
    from repro_torch.configs.base import ShapeConfig
    return {"prefill": ShapeConfig("prefill_b1_s1024", 1024, 1, "prefill"),
            "decode": ShapeConfig("decode_b4_kv516", 516, 4, "decode",
                                  kv_len=516)}


# ===========================================================================
# Phase 3c: the trace front-end on the card
# ===========================================================================
#: Traced against analytic weight-matmul FLOPs: the reference's ``diff``
#: bar (``--tol``).
TRACE_MATMUL_TOL = 0.05


def trace_keys(wl):
    """What two traces must agree on, op for op: kind, name (K, N and
    count), FLOPs and weight bytes."""
    return [(o.kind, o.name, o.flops, o.weight_bytes) for o in wl.ops]


def trace_phase(cfg, params, rt, counters, measured):
    """``[trace]``: the trace front-end (``core.workload.torch_trace``) at
    the cells of :func:`served_shapes`. For each: the trace of the call
    on the card (these weights, ``rt`` as served: the ``cuda`` policy,
    every launch count set to 0 first; the model's kernels must launch
    and no other path's) must equal the abstract trace (``meta``, the
    same runtime under the ``torch`` policy) op for op; its weight-matmul
    FLOPs must be within ``TRACE_MATMUL_TOL`` of the analytic profile's
    (qwen2-moe is served dropless: its grouped GEMMs run the K T routed
    rows the profile counts); the one-card model's prediction on the
    traced workload is printed beside the analytic profile's and the
    device time ``profile_model`` measured (ms). Returns the launch
    counts and the seconds taken."""
    import dataclasses
    import torch
    from repro_torch.core.analytical import DesignPoint, GPUModel
    from repro_torch.core.workload import (diff_workloads, lm_workload,
                                           trace_workload)
    from repro_torch.kernels.dispatch import TORCH_POLICY

    t0 = time.perf_counter()
    launches = dict.fromkeys(counters, 0)
    point = DesignPoint.make(log2_m=0, quant=0)
    for phase, shape in served_shapes().items():
        label = f"{cfg.name}/{phase}"
        expect = {"rmsnorm"} if uses_rmsnorm(cfg) else set()
        if cfg.family != "ssm":
            expect.add("flash_attention" if phase == "prefill"
                       else "decode_attention")
        if cfg.family == "moe":
            expect.add("moe_gemm")
        if cfg.family in ("ssm", "hybrid") and phase == "prefill":
            expect.add("ssd_scan")
        for fn in counters.values():
            fn.launches = 0
        card = trace_workload(cfg, shape, rt=rt, params=params)
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items()}
        for name, n in got.items():
            check((n > 0) == (name in expect), f"[trace] {label}: kernel "
                  f"{name} launched {n} times (expected: {sorted(expect)})")
            launches[name] += n
        abstract = trace_workload(
            cfg, shape, rt=dataclasses.replace(rt, kernels=TORCH_POLICY))
        check(abstract.meta["param_bytes"] == card.meta["param_bytes"],
              f"[trace] {label}: parameter bytes differ")
        check(trace_keys(card) == trace_keys(abstract),
              f"[trace] {label}: the card trace {trace_keys(card)} differs "
              f"from the abstract trace {trace_keys(abstract)}")
        d = diff_workloads(lm_workload(cfg, shape), card)
        check(abs(d["matmul_ratio"] - 1.0) <= TRACE_MATMUL_TOL,
              f"[trace] {label}: matmul_ratio {d['matmul_ratio']}")
        priced, terms = {}, []
        for src, wl in (("traced", card), ("analytic", None)):
            r = GPUModel(cfg, shape, workload=wl).evaluate(point)
            check(r.feasible and r.latency_s > 0,
                  f"[trace] {label}: {src} prediction {r}")
            priced[src] = r.latency_s * 1e3
            terms.append(f"{src} compute {r.detail.compute_s * 1e3:.3f} "
                         f"memory {r.detail.memory_s * 1e3:.3f}")
        print(f"[trace] {label} ops {len(card.ops)} matmul "
              f"{d['matmul_ratio']:.4f} activation "
              f"{d['activation_ratio']:.4f} weight-bytes "
              f"{d['weight_bytes_ratio']:.4f} predicted(traced) "
              f"{priced['traced']:.3f} predicted(analytic) "
              f"{priced['analytic']:.3f} device "
              f"{measured[phase]['device_ms']:.3f}")
        print(f"[trace] {label}: card trace == abstract trace, "
              f"{len(card.ops)} ops ({card.meta['trace_eqns']} aten ops "
              f"on the card, {abstract.meta['trace_eqns']} on meta); "
              f"terms (ms) {'; '.join(terms)}; launches {got}")
    return launches, time.perf_counter() - t0


# ===========================================================================
# Phase 4: logit parity, cuda vs torch policy
# ===========================================================================
#: The logit_parity run whose max_logit_dev ``[explore]`` prints beside
#: the DSE's int8 accuracy proxy.
INT8_KV_LABEL = "bf16 KV vs int8 KV, cuda policy"


def parity_inputs(cfg, seed, lengths=(300, 177), steps=8):
    """Two 300-token prompts (real lengths ``lengths``, or exact when
    None) and ``steps`` teacher-forced tokens per sequence."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), generator=gen,
                         device=dev)
    forced = torch.randint(0, cfg.vocab_size, (steps, 2), generator=gen,
                           device=dev)
    if lengths is not None:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return toks, lengths, forced


def cuda_vs_torch(params, cfg, inputs, on_policy=None, **rt_kw):
    """Teacher-forced logits (steps + 1, B, V) f32 under the ``cuda`` and
    the ``torch`` policy: prefill, then decode steps fed the forced
    tokens. ``on_policy(name)`` runs before each policy's pass."""
    import torch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, decode_step, prefill

    toks, lengths, forced = inputs
    logs = []
    for pol in ("cuda", "torch"):
        rt = ModelRuntime(kernels=getattr(KernelPolicy, pol)(), **rt_kw)
        if on_policy is not None:
            on_policy(pol)
        with torch.no_grad():
            cache, log = prefill(params, cfg, {"tokens": toks}, 1024, rt,
                                 lengths=lengths)
            out = [log.float()]
            for t in range(forced.shape[0]):
                cache, log = decode_step(params, cfg, cache, forced[t], rt)
                out.append(log.float())
        logs.append(torch.stack(out))
        del cache
    for pol, lg in zip(("cuda", "torch"), logs):
        check(tuple(lg.shape) == (forced.shape[0] + 1, toks.shape[0],
                                  cfg.vocab_size),
              f"{cfg.name} {pol}: logit shape {tuple(lg.shape)}")
        check(bool(torch.isfinite(lg).all()),
              f"{cfg.name} {pol}: non-finite logits")
    return logs


def agreement(a, b) -> str:
    return (f"max|dlogit| {float((a - b).abs().max()):.4f}, max|logit| "
            f"{float(b.abs().max()):.3f}, argmax agreement "
            f"{float((a.argmax(-1) == b.argmax(-1)).float().mean()):.3f}")


def moe_parity(cfg, params):
    """qwen2-moe, cuda vs torch policy, prefill (lengths 300/177) + 8
    teacher-forced decode steps, dropless as served. Full depth in bf16
    is reported, not asserted: a 4th/5th-expert near-tie that bf16
    rounding flips moves that token's logits by more than LOGIT_TOL. The
    assertion is in f32 at full width and MOE_PARITY_LAYERS layers."""
    import dataclasses
    from repro_torch.models import ModelRuntime, init_params
    from repro_torch.models import moe as MOE

    routes = {}
    route = MOE._route

    def recording(p, xt, c, dpl=None):
        g, idx, aux = route(p, xt, c, dpl)
        routes[current].append(idx)
        return g, idx, aux

    def on_policy(pol):
        nonlocal current
        current = pol
        routes[pol] = []

    current = None
    inputs = parity_inputs(cfg, 17)
    MOE._route = recording
    try:
        a, b = cuda_vs_torch(params, cfg, inputs, on_policy,
                             moe_dropless=True)
    finally:
        MOE._route = route
    check(len(routes["cuda"]) == len(routes["torch"]) > 0, "route calls")
    same = sum(int((x == y).sum()) for x, y in zip(routes["cuda"],
                                                   routes["torch"]))
    total = sum(x.numel() for x in routes["cuda"])
    print(f"[parity] {cfg.name} full depth ({cfg.n_layers} layers) bf16, "
          f"prefill S300 (lengths 300/177) + 8 decode steps, cuda vs torch "
          f"(reported): {agreement(a, b)}, routing agreement {same}/{total} "
          f"(token, k) choices ({same / total:.5f})")

    small = dataclasses.replace(cfg, n_layers=MOE_PARITY_LAYERS)
    params32 = init_params(small, seed=0, rt=ModelRuntime(dtype="float32"))
    a, b = cuda_vs_torch(params32, small, inputs, dtype="float32",
                         moe_dropless=True)
    del params32
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"[parity] {cfg.name} full width, {MOE_PARITY_LAYERS} layers, f32, "
          f"cuda vs torch: max|dlogit| / max|logit| {rel:.3e} (tol "
          f"{MOE_F32_RTOL:g}); {agreement(a, b)}")
    check(rel <= MOE_F32_RTOL, f"{cfg.name} f32 relative logit error {rel}")


def ssm_parity(cfg, params, inputs=None):
    """mamba2 (and zamba2), cuda vs torch policy, exact-length prefill (a
    recurrent state takes no pad) + 8 teacher-forced decode steps,
    bf16."""
    if inputs is None:
        inputs = parity_inputs(cfg, 19, lengths=None)
    a, b = cuda_vs_torch(params, cfg, inputs)
    dev_max = float((a - b).abs().max())
    per_step = " ".join(f"{float((x - y).abs().max()):.4f}"
                        for x, y in zip(a, b))
    print(f"[parity] {cfg.name} full depth ({cfg.n_layers} layers) bf16, "
          f"prefill S300 + 8 decode steps, cuda vs torch: {agreement(a, b)} "
          f"(tol {LOGIT_TOL}); max|dlogit| by step: {per_step}")
    check(dev_max <= LOGIT_TOL, f"{cfg.name} max|dlogit| {dev_max} > "
          f"{LOGIT_TOL}")


def hybrid_parity(cfg, params):
    """zamba2, exact-length prompts (a recurrent state takes no pad) + 8
    teacher-forced decode steps: cuda vs torch policy in bf16 within
    LOGIT_TOL; ``logit_parity`` of int8 KV under the torch and the cuda
    policy within QUANT_PARITY_TOL. bf16 vs int8 KV is reported under
    both policies, not asserted: 54 random-weight Mamba-2 layers carry
    int8 rounding past the bar in the plain versions too
    (``repro_torch.bench.logit_sensitivity``). Returns bf16 vs int8 KV's
    max_logit_dev under the cuda policy."""
    import dataclasses
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.quant import QUANT_PARITY_TOL
    from repro_torch.models import ModelRuntime
    from repro_torch.serve import logit_parity

    inputs = parity_inputs(cfg, 23, lengths=None)
    ssm_parity(cfg, params, inputs)
    rows = inputs[0].cpu().numpy()
    prompts = [rows[0], rows[1]]
    rt = ModelRuntime()
    rt8 = dataclasses.replace(rt, kv_dtype="int8")
    torch_pol = KernelPolicy.torch()
    for label, ref, test, asserted in (
            ("int8 KV, torch vs cuda policy",
             dataclasses.replace(rt8, kernels=torch_pol), rt8, True),
            (INT8_KV_LABEL, rt, rt8, False),
            ("bf16 KV vs int8 KV, torch policy",
             dataclasses.replace(rt, kernels=torch_pol),
             dataclasses.replace(rt8, kernels=torch_pol), False)):
        report = logit_parity(params, cfg, prompts, rt_ref=ref, rt_test=test,
                              max_new_tokens=8, max_len=1024)
        if label == INT8_KV_LABEL:
            int8_dev = report.max_logit_dev
        print(f"[parity] {cfg.name} logit_parity {label}, prompts S300 "
              f"(exact){'' if asserted else ' (reported)'}: "
              f"{json.dumps(report.to_json())}")
        check(not asserted or report.max_logit_dev <= QUANT_PARITY_TOL,
              f"{cfg.name} {label}: max_logit_dev {report.max_logit_dev} > "
              f"{QUANT_PARITY_TOL}")
    return int8_dev


def parity_phase(cfg, params, int8=True):
    """cuda vs torch teacher-forced logits in bf16 within LOGIT_TOL, then
    (``int8``) the port's ``logit_parity`` for bf16 vs int8 KV and for
    int8 KV under both policies, on the same prompts, each within
    QUANT_PARITY_TOL. Returns bf16 vs int8 KV's max_logit_dev, or None
    without ``int8``."""
    import dataclasses
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.quant import QUANT_PARITY_TOL
    from repro_torch.models import ModelRuntime
    from repro_torch.serve import logit_parity

    inputs = parity_inputs(cfg, 7)
    a, b = cuda_vs_torch(params, cfg, inputs)
    dev_max = float((a - b).abs().max())
    print(f"[parity] {cfg.name} ({cfg.n_layers} layers) prefill S=300 "
          f"(lengths 300/177) + 8 decode steps, bf16: {agreement(a, b)} "
          f"(tol {LOGIT_TOL})")
    check(dev_max <= LOGIT_TOL,
          f"{cfg.name} max|dlogit| {dev_max} > {LOGIT_TOL}")
    if not int8:
        return None

    rows = inputs[0].cpu().numpy()
    prompts = [rows[0, :300], rows[1, :177]]
    rt = ModelRuntime()
    rt8 = dataclasses.replace(rt, kv_dtype="int8")
    for label, ref, test in (
            (INT8_KV_LABEL, rt, rt8),
            ("int8 KV, torch vs cuda policy",
             dataclasses.replace(rt8, kernels=KernelPolicy.torch()), rt8)):
        report = logit_parity(params, cfg, prompts, rt_ref=ref,
                              rt_test=test, max_new_tokens=8, max_len=1024)
        print(f"[parity] {cfg.name} logit_parity {label}: "
              f"{json.dumps(report.to_json())}")
        check(report.max_logit_dev <= QUANT_PARITY_TOL,
              f"{cfg.name} {label}: max_logit_dev {report.max_logit_dev} > "
              f"{QUANT_PARITY_TOL}")
        if label == INT8_KV_LABEL:
            int8_dev = report.max_logit_dev
    return int8_dev


# ===========================================================================
# Phase 4b: the last-ported families
# ===========================================================================
#: The four decoders of the ``[families]`` phase (full width and depth),
#: then the audio encoder.
FAMILY_DECODERS = ("chatglm3-6b", "starcoder2-3b", "stablelm-12b",
                   "qwen2-vl-7b")
ENCODER = "hubert-xlarge"
#: qwen2-vl-7b's M-RoPE prefill: one image of 32 x 32 patches.
PATCH_GRID = 32


def uses_rmsnorm(cfg) -> bool:
    """Whether ``cfg``'s path runs the RMSNorm kernel: its block norms,
    or (stablelm-12b, a LayerNorm model) its qk-norm."""
    return cfg.norm == "rmsnorm" or cfg.qk_norm


def counted(counters, fn):
    """``fn()`` with every launch count set to 0 just before; returns its
    result and the counts just after."""
    import torch
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items()}


def mrope_prefill(cfg, params, counters):
    """qwen2-vl-7b prefilled from patch embeddings (B 1, S 1024) with
    M-RoPE positions laid out as one image: the temporal component
    constant, height and width over a 32 x 32 grid; its last-token
    logits cuda vs torch within LOGIT_TOL. Returns the cuda run's
    launch counts."""
    import torch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    S = PATCH_GRID * PATCH_GRID
    embeds = (torch.randn(1, S, cfg.d_model, generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
    i = torch.arange(S, dtype=torch.int32, device=dev)
    pos = torch.stack([torch.zeros_like(i), i // PATCH_GRID,
                       i % PATCH_GRID])[:, None, :]          # (3, 1, S)
    batch = {"embeds": embeds, "positions": pos}
    logs = {}
    with torch.no_grad():
        for pol in ("cuda", "torch"):
            rt = ModelRuntime(kernels=getattr(KernelPolicy, pol)())
            (_, lg), got = counted(counters,
                                   lambda: prefill(params, cfg, batch, S, rt))
            logs[pol] = lg.float()
            if pol == "cuda":
                launches = got
    for name, n in launches.items():
        check((n > 0) == (name in ("rmsnorm", "flash_attention")),
              f"{cfg.name} M-RoPE prefill: {name} launched {n} times")
    a, b = logs["cuda"], logs["torch"]
    check(tuple(a.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(a).all()), f"{cfg.name} M-RoPE logits")
    dev_max = float((a - b).abs().max())
    print(f"[families] {cfg.name} prefill from patch embeddings B1 S{S}, "
          f"M-RoPE positions of a {PATCH_GRID} x {PATCH_GRID} grid "
          f"(temporal 0, height, width), cuda vs torch: {agreement(a, b)} "
          f"(tol {LOGIT_TOL}); launches {launches}")
    check(dev_max <= LOGIT_TOL, f"{cfg.name} M-RoPE prefill max|dlogit| "
          f"{dev_max} > {LOGIT_TOL}")
    return launches


def encoder_run(cfg, params, counters):
    """hubert-xlarge: ``forward`` from frame embeddings at B 2, S 1024
    under both policies (logits within LOGIT_TOL; the cuda run launches
    flash, non-causal at head dim 80, and no decode kernel), a device
    profile of one forward, and ``ServeEngine`` refusing the encoder.
    Returns the cuda run's launch counts."""
    import torch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, forward
    from repro_torch.serve import ServeEngine

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    embeds = (torch.randn(2, 1024, cfg.d_model, generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
    logs = {}
    with torch.no_grad():
        for pol in ("cuda", "torch"):
            rt = ModelRuntime(kernels=getattr(KernelPolicy, pol)())
            (lg, _), got = counted(counters, lambda: forward(
                params, cfg, {"embeds": embeds}, rt))
            logs[pol] = lg.float()
            if pol == "cuda":
                launches = got
        rt = ModelRuntime()
        device_profile(
            f"{cfg.name} forward B2 S1024 (frames), non-causal",
            lambda: forward(params, cfg, {"embeds": embeds}, rt), steps=3,
            focus=("flash_fwd",))
    for name, n in launches.items():
        check((n > 0) == (name == "flash_attention"),
              f"{cfg.name} forward: {name} launched {n} times")
    a, b = logs["cuda"], logs["torch"]
    check(tuple(a.shape) == (2, 1024, cfg.vocab_size)
          and bool(torch.isfinite(a).all()), f"{cfg.name} logits")
    dev_max = float((a - b).abs().max())
    print(f"[families] {cfg.name} full depth ({cfg.n_layers} layers) "
          f"forward B2 S1024 from frame embeddings, non-causal flash at D "
          f"{cfg.head_dim}, cuda vs torch: {agreement(a, b)} (tol "
          f"{LOGIT_TOL}); launches {launches}")
    check(dev_max <= LOGIT_TOL, f"{cfg.name} max|dlogit| {dev_max} > "
          f"{LOGIT_TOL}")
    try:
        ServeEngine(params, cfg, ModelRuntime(), n_slots=4, max_len=1024)
    except ValueError as e:
        print(f"[families] {cfg.name} ServeEngine refuses: {e}")
    else:
        check(False, f"{cfg.name}: ServeEngine accepted an encoder")
    return launches


def families_phase(counters):
    """``[families]``: the four decoders at full width and depth with
    seeded random bf16 weights, each through ``ServeEngine`` and
    ``PagedServeEngine`` (equal streams; stablelm-12b in int8 KV too),
    a decode-step and a prefill profile, ``[trace]``, and cuda vs torch
    logit parity (stablelm's bf16 vs int8 KV and int8 KV under both
    policies); qwen2-vl's M-RoPE prefill from patch embeddings;
    hubert-xlarge's forward. Each model is freed before the next. Returns the serving launch counts,
    the trace launch counts and seconds, the decoders' profiles for
    ``[explore]`` and the measured bf16 vs int8 KV deviation."""
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import ModelRuntime, init_params

    t_phase = time.perf_counter()
    serve, traced = [], dict.fromkeys(counters, 0)
    t_trace, measured, int8_devs = 0.0, {}, {}
    rt = ModelRuntime()                  # bf16, cuda policy, on the card
    for name in FAMILY_DECODERS + (ENCODER,):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = get_arch(name)
        params = init_params(cfg, seed=0, rt=rt)     # cast leaf by leaf
        torch.cuda.synchronize()
        print(f"[families] {name} full width: {cfg.n_layers} layers, "
              f"{cfg.param_count() / 1e9:.3f} B params in bf16 (d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
              f"{cfg.head_dim}), seeded init {time.perf_counter() - t0:.1f} "
              f"s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the "
              f"card")
        if name == ENCODER:
            serve.append(encoder_run(cfg, params, counters))
        else:
            expect = {"flash_attention"} | (
                {"rmsnorm"} if uses_rmsnorm(cfg) else set())
            int8 = name == "stablelm-12b"
            serve.append(serve_pair(
                name, cfg, params, rt, counters, expect, True,
                kv_dtypes=(None, "int8") if int8 else (None,)))
            _, _, measured[name] = profile_model(
                name, cfg, params, rt, prefill_focus=("flash_fwd",),
                decode_focus=(BF16_KERNEL,))
            got, dt = trace_phase(cfg, params, rt, counters, measured[name])
            traced = {k: traced[k] + got[k] for k in counters}
            t_trace += dt
            int8_dev = parity_phase(cfg, params, int8=int8)
            if int8:
                int8_devs[name] = int8_dev
            if cfg.rope == "mrope":
                serve.append(mrope_prefill(cfg, params, counters))
        del params
        torch.cuda.synchronize()
        print(f"[families] {name}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[families] phase {time.perf_counter() - t_phase:.1f} s")
    totals = {k: sum(r[k] for r in serve) for k in counters}
    return totals, traced, t_trace, measured, int8_devs


# ===========================================================================
# [launch]: the serve launcher's gates and the two examples
# ===========================================================================
#: The launcher's scenario runs: full-width minicpm-2b, paged, chat_burst.
LAUNCH_ARGS = ("--arch", "minicpm-2b", "--scenario", "chat_burst",
               "--preflight", "--page-size", "16", "--max-len", "1024",
               "--requests", "8")
#: Configs the launcher must refuse before allocating, with the rule
#: each refusal names.
LAUNCH_REFUSALS = (
    (("--arch", "stablelm-12b", "--slots", "64", "--max-len", "8192",
      "--preflight"), "capacity-hbm-overflow"),
    (("--arch", "minicpm-2b", "--preflight", "--hbm-gb", "4"),
     "capacity-hbm-overflow"),
    (("--arch", "minicpm-2b", "--scenario", "rag_long_context",
      "--page-size", "16", "--page-budget", "8", "--strict"),
     "deploy-admission-deadlock"))
#: train_100m's two runs on one checkpoint directory: the first
#: checkpoints at step 10 and stops at 20, the second resumes from step
#: 10 for the example's default 300 steps. Over 20 or 50 steps this
#: recipe's loss rises (10.55 -> 11.21 on the card; the reference's own
#: example on the CPU 10.51 -> 11.12 over 20): lr 3e-3 after a 2-3 step
#: warmup; it falls from step ~150 of a 300-step run.
TRAIN_100M_STEPS = (20, 300)
#: Losses averaged at each end of the two runs for "the loss falls".
LOSS_WINDOW = 10


def echoed(fn, *args):
    """``fn(*args)`` with its standard output captured and echoed as
    ``[launch]`` lines (but each request's tokens); returns (its result,
    the output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    text = buf.getvalue()
    for line in text.splitlines():
        if not line.lstrip().startswith("rid="):      # per-request tokens
            print(f"[launch]   {line[:200]}")
    return out, text


def expect_launches(label, launches, expect):
    for name, n in launches.items():
        if name in expect:
            check(n > 0, f"{label}: kernel {name} was not launched")
        else:
            check(n == 0, f"{label}: kernel {name} of another path ran "
                          f"{n} times")


def launcher_runs(counters):
    """``repro_torch.launch.serve.main`` in-process, full-width minicpm-2b
    from chat_burst with ``--preflight`` (bf16 and int8 KV): every request
    served, the paged kernel of the KV dtype launched, the deploy lower
    bound at or below the measured step p50, the prefill shapes within
    the deploy inventory, the measured peak in a ``[capacity]`` line;
    then the three refusals, each naming its rule with nothing
    allocated. Returns the launch counts."""
    import torch
    from repro_torch.launch import serve as launcher

    runs = []
    for kvd, kernel in ((None, "paged_decode_attention"),
                        ("int8", "quant_paged_decode_attention")):
        argv = list(LAUNCH_ARGS) + (["--kv-dtype", kvd] if kvd else [])
        label = f"launcher {' '.join(argv)}"
        gc.collect()
        torch.cuda.empty_cache()
        other = peak_start()
        (out, text), launches = counted(
            counters, lambda: echoed(launcher.main, argv))
        check("deploy[chat_burst]: rho=" in text and "preflight: " in text,
              f"{label}: no deploy/preflight lines")
        check(out["served"] == 8 and out["rejected"] == 0,
              f"{label}: served {out['served']}/8, rejected "
              f"{out['rejected']}")
        expect_launches(label, launches,
                        {"rmsnorm", "flash_attention", kernel})
        cap, drep = out["preflight"], out["deploy"]
        # held to PARITY_REL_TOL with every other run's, in [capacity]
        rec = capacity_record("minicpm-2b", "decode", "launcher paged", kvd,
                              cap, other)
        check(drep.tok_p50_lb_ms <= out["step_p50_ms"],
              f"{label}: deploy lower bound {drep.tok_p50_lb_ms} ms over "
              f"the measured step p50 {out['step_p50_ms']} ms")
        check(out["stats"].prefill_compiles <= drep.compiles,
              f"{label}: {out['stats'].prefill_compiles} prefill shapes > "
              f"the deploy inventory {drep.compiles}")
        print(f"[launch] minicpm-2b chat_burst paged {kvd or 'bf16'}: "
              f"served {out['served']} requests, {out['tokens']} tokens in "
              f"{out['seconds']:.3f} s; step p50 {out['step_p50_ms']:.2f} ms "
              f"p99 {out['step_p99_ms']:.2f} ms >= deploy lower bound tok "
              f"p50 {drep.tok_p50_lb_ms:.4f} ms (p99 "
              f"{drep.tok_p99_lb_ms:.4f}, ttft {drep.ttft_lb_ms:.3f}); "
              f"rho {drep.rho:.4f} at batch {drep.best_batch}; prefill "
              f"shapes {out['stats'].prefill_compiles} <= inventory "
              f"{drep.compiles}; peak predicted {cap.peak_bytes} B, "
              f"measured {rec['measured_bytes']} B (rel err "
              f"{rec['rel_err']:.4f}); launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        runs.append(launches)
        del out
    for argv, rule in LAUNCH_REFUSALS:
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        try:
            echoed(launcher.main, list(argv))
        except SystemExit as e:
            msg = str(e.code)
        else:
            msg = ""
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        check(msg.startswith(f"[{rule}]"),
              f"launcher {' '.join(argv)}: expected [{rule}], got {msg!r}")
        check(after == before, f"launcher {' '.join(argv)}: {after - before}"
                               f" B allocated by a refused config")
        print(f"[launch] refused {' '.join(argv)}: {msg[:160]}; allocated "
              f"{after - before} B")
    return runs


def example_runs(counters):
    """``serve_batched`` on the card in f32 under both policies (the same
    tokens; the cuda run launches flash and the contiguous split-KV
    kernel, the torch run nothing), paged (== contiguous) and int8 KV;
    ``train_100m`` twice on one checkpoint directory: the second run
    resumes from the first's last checkpoint. Returns the launch
    counts."""
    import tempfile
    import torch
    from repro_torch.analysis.capacity import capacity
    from repro_torch.ckpt import latest_step
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.examples import serve_batched, train_100m

    runs, toks = [], {}
    for name, argv, expect in (
            ("torch", [], set()),
            ("cuda", ["--use-kernels"],
             {"flash_attention", "decode_attention"}),
            ("cuda paged", ["--use-kernels", "--page-size", "8"],
             {"flash_attention", "paged_decode_attention"}),
            ("cuda int8", ["--use-kernels", "--kv-dtype", "int8"],
             {"flash_attention", "quant_decode_attention"})):
        (out, _), launches = counted(counters, lambda: echoed(
            serve_batched.main, ["--device", "cuda"] + argv))
        expect_launches(f"serve_batched {name}", launches, expect)
        toks[name] = out["tokens"]
        check(len(toks[name]) == 10, f"serve_batched {name}: "
              f"{len(toks[name])} of 10 requests")
        runs.append(launches)
        print(f"[launch] serve_batched {name}: {len(toks[name])} requests, "
              f"{sum(map(len, toks[name].values()))} tokens; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
    check(toks["cuda"] == toks["torch"],
          "serve_batched: cuda and torch policies' f32 tokens differ")
    check(toks["cuda paged"] == toks["cuda"],
          "serve_batched: paged tokens differ from contiguous")
    print("[launch] serve_batched f32: cuda tokens == torch tokens; paged "
          "== contiguous")

    with tempfile.TemporaryDirectory(prefix="train100m_") as d:
        res = []
        for steps in TRAIN_100M_STEPS:
            gc.collect()
            torch.cuda.empty_cache()
            last = latest_step(d)
            other = peak_start()
            (out, _), launches = counted(counters, lambda: echoed(
                train_100m.main, ["--steps", str(steps), "--ckpt-dir", d]))
            capacity_record("train_100m", "train", f"train f32 B8 S256 "
                            f"{steps} steps", None, capacity(
                                train_100m.model_config(),
                                ShapeConfig("train", 256, 8, "train")),
                            other)
            expect_launches(f"train_100m --steps {steps}", launches,
                            {"rmsnorm", "flash_attention"})
            check(out["start"] == last, f"train_100m --steps {steps}: "
                  f"started from {out['start']}, latest checkpoint {last}")
            check(all(math.isfinite(x) for x in out["losses"]),
                  f"train_100m: non-finite loss {out['losses']}")
            res.append(out)
            runs.append(launches)
        first, second = res
        check(second["start"] is not None and second["start"] > 0,
              "train_100m: the second run did not resume")
        head = statistics.mean(first["losses"][:LOSS_WINDOW])
        tail = statistics.mean(second["losses"][-LOSS_WINDOW:])
        print(f"[launch] train_100m: run 1 {TRAIN_100M_STEPS[0]} steps, "
              f"loss {first['losses'][0]:.4f} -> {first['losses'][-1]:.4f}"
              f"; run 2 resumed from step {second['start']}, "
              f"{TRAIN_100M_STEPS[1]} steps, loss "
              f"{second['losses'][0]:.4f} -> {second['losses'][-1]:.4f}; "
              f"mean of run 1's first {LOSS_WINDOW} {head:.4f}, of run 2's "
              f"last {LOSS_WINDOW} {tail:.4f}")
        check(tail < head, f"train_100m: the loss did not fall ({head:.4f}"
                           f" -> {tail:.4f})")
    return runs


def launch_phase(counters):
    """``[launch]``: the launcher's gates on the card, then the two
    examples. Returns the phase's launch counts, summed."""
    t0 = time.perf_counter()
    runs = launcher_runs(counters) + example_runs(counters)
    launched = {k: sum(r[k] for r in runs) for k in counters}
    print(f"[launch] launches {launched}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return launched


# ===========================================================================
# [dryrun]: the dry-run of a mesh of H100s, and its ties to the meshes here
# ===========================================================================
#: The bar of a tie's peak: the dry trace's within this share of the
#: rank's ``max_memory_allocated`` over the same step.
DRYRUN_PEAK_TOL = 0.25


def tie_specs():
    """[dryrun]'s eight ties: per tie, the arch, its depth, the mesh and
    its axes, the recipe (None for the pipeline-parallel step) and its
    runs ``(label, shape, rt)``, at the shapes of the spawn each is tied
    in (``[sharded]``'s 4 slots x 1024, a 300-token prefill;
    ``[sharded-train]``'s B 4 S 256). A tie whose mesh is not its
    spawn's builds it over the spawn's ranks. The PP tie's shape is
    ``(n_micro, mb, seq)`` of ``launch.dryrun_pp``'s step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.lowering import cell_runtime
    from repro_torch.models import ModelRuntime
    serve = ModelRuntime()                        # bf16, cuda policy
    train = ModelRuntime(dtype="bfloat16", remat="none")
    decode = ("decode B 4 KV 1024", ShapeConfig("decode", 1024, 4,
                                                "decode"), serve)
    step = (f"train B {SHARDED_TRAIN_B} S {SHARDED_TRAIN_S}", ShapeConfig(
        "train", SHARDED_TRAIN_S, SHARDED_TRAIN_B, "train"), train)
    pod = ("pod", "data", "model")

    def tie(arch, layers, mesh, recipe, runs, axes=("data", "model")):
        return dict(arch=arch, layers=layers, mesh=mesh, axes=axes,
                    recipe=recipe, runs=runs)

    return {
        "minicpm-2b": tie("minicpm-2b", SHARDED_LAYERS["minicpm-2b"], (1, 2),
                          "decode", [("prefill B 1 S 300", ShapeConfig(
                              "prefill", SHARDED_PREFILL, 1, "prefill"),
                              serve), decode]),
        "chatglm3-6b": tie("chatglm3-6b", SHARDED_LAYERS["chatglm3-6b"],
                           (1, 4), "decode", [decode]),
        "qwen2-moe-a2.7b": tie("qwen2-moe-a2.7b",
                               SHARDED_FAMILY_LAYERS["qwen2-moe-a2.7b"],
                               (1, 4), "decode", [decode]),
        "chatglm3-6b zero3": tie("chatglm3-6b", ZERO3_LAYERS["chatglm3-6b"],
                                 (2, 1), "decode+zero3", [decode]),
        "minicpm-2b train": tie("minicpm-2b",
                                SHARDED_TRAIN_LAYERS["minicpm-2b"], (2, 2),
                                "IS", [step]),
        # the pod axis: the batch over pod x data, in [sharded]'s (1, 8)
        # spawn and [sharded-train]'s (2, 2) one
        "qwen2-moe-a2.7b pod": tie("qwen2-moe-a2.7b", SPLIT_LAYERS,
                                   (2, 2, 2), "decode", [decode], pod),
        "minicpm-2b pod train": tie("minicpm-2b",
                                    SHARDED_TRAIN_LAYERS["minicpm-2b"],
                                    (2, 2, 1), "IS", [step], pod),
        # launch.dryrun_pp's step, in [sharded-train]'s (1, 4) spawn
        "chatglm3-6b pp": tie("chatglm3-6b",
                              SHARDED_TRAIN_LAYERS["chatglm3-6b"], (2, 1, 2),
                              None, [("pp train 4 x 1 x 256", PP_TIE_SHAPE,
                                      cell_runtime())],
                              ("stage", "data", "model")),
    }


#: The PP tie's step: microbatches, rows of one, tokens a row.
PP_TIE_SHAPE = (4, 1, 256)
#: [dryrun]'s cells of the full preset beside every arch's decode_32k
#: on both meshes: (arch, shape, mesh).
DRYRUN_TRAIN_CELLS = (("chatglm3-6b", "train_4k", "single"),
                      ("chatglm3-6b", "train_4k", "multi"))


def dryrun_start(started):
    """``[dryrun]``, started in ``[graph]``'s workers (:func:`graph_start`),
    after its traces: the dry traces of every rank of each tie
    (``lowering.trace_ranks``, ``dryrun_pp.trace_pp_ranks``) and every
    arch's ``full`` ``decode_32k`` cell at (16, 16) and (2, 16, 16), on
    ``meta``. Returns the futures (:func:`dryrun_phase` adds the
    train and PP cells')."""
    import dataclasses
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.dist.sharding import get_recipe
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.dryrun_pp import trace_pp_ranks
    from repro_torch.launch.lowering import trace_ranks
    from repro_torch.launch.presets import FULL, MeshSpec
    ex = started[0]
    ties = {}
    for name, t in tie_specs().items():
        cfg = dataclasses.replace(get_arch(t["arch"]), n_layers=t["layers"])
        if t["recipe"] is None:
            ties[name] = [ex.submit(trace_pp_ranks, cfg, t["mesh"],
                                    t["axes"], *shape, rt)
                          for _, shape, rt in t["runs"]]
            continue
        spec = MeshSpec(t["mesh"], t["axes"])
        ties[name] = [ex.submit(trace_ranks, cfg, shape, spec,
                                get_recipe(t["recipe"]), rt)
                      for _, shape, rt in t["runs"]]
    cells = {(a, "decode_32k", m): ex.submit(run_cell, FULL, a, "decode_32k",
                                             m)
             for m in ("single", "multi") for a in sorted(ARCHS)}
    return dict(cells=cells, ties=ties)


def _mesh_text(art) -> str:
    return str(tuple(art["mesh_axes"].values()))


def dryrun_cell_line(art) -> None:
    """A full cell's line: recipe, per-rank peak against the card's
    memory, the three roofline terms and the links of each axis."""
    hbm = H100_SXM.hbm_bytes
    mem, r = art["memory"], art["roofline"]
    print(f"[dryrun] full {art['arch']}/{art['shape']} at {_mesh_text(art)}"
          f" under {art['recipe']}: per-rank peak {mem['peak_bytes']} B "
          f"({mem['peak_bytes'] / hbm:.3f} of {hbm:.0f} B: "
          f"{'fits' if mem['peak_bytes'] <= hbm else 'does not fit'}), "
          f"arguments {mem['argument_bytes']} B; predicted from "
          f"H100_SXM's data-sheet constants: compute "
          f"{r['compute_s'] * 1e3:.4f} ms, memory "
          f"{r['memory_s'] * 1e3:.4f} ms, collective "
          f"{r['collective_s'] * 1e3:.4f} ms (links "
          f"{art['collectives']['axis_links']}), dominant "
          f"{r['dominant']}, step bound "
          f"{r['step_time_bound_s'] * 1e3:.4f} ms; ranks traced "
          f"{art['ranks_traced']}, {art['trace_s']:.1f} s")


def dryrun_write(art, sub: str, name: str) -> None:
    out = ROOT / "chiprun_out" / "dryrun" / sub
    out.mkdir(parents=True, exist_ok=True)
    with open(out / name, "w") as f:
        json.dump(art, f, indent=1)


def dryrun_phase(started, futures):
    """``[dryrun]``'s host part (:func:`dryrun_start`), read after
    ``[graph]``: each full ``decode_32k`` cell's recipe, per-rank peak
    against the card's memory and roofline terms, written under
    ``chiprun_out/dryrun/full/``; no FAIL, SKIP exactly where
    ``shape_skip_reason`` says. Returns the ties' traces by name, for
    the spawns that tie them. Then the train and PP cells start in the
    workers, freed by now (:func:`dryrun_late` reads them)."""
    from repro_torch.configs import get_arch, shape_skip_reason
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.dryrun_pp import lower_pp
    from repro_torch.launch.presets import FULL
    t0 = time.perf_counter()
    cells, ties = futures["cells"], futures["ties"]
    try:
        traces = {k: [f.result() for f in fs] for k, fs in ties.items()}
        arts = {k: f.result() for k, f in cells.items()}
    except BaseException:
        started[0].shutdown(cancel_futures=True)
        raise
    for (arch, shape, mesh), art in arts.items():
        dryrun_write(art, "full", f"{arch}__{shape}__{mesh}.json")
        skip = shape_skip_reason(get_arch(arch), FULL.shape(shape))
        check(art["status"] == ("SKIP" if skip else "OK"),
              f"[dryrun] {arch}/{shape}/{mesh}: {art['status']} "
              f"{art.get('error', '')}")
        if skip:
            print(f"[dryrun] full {arch}/{shape} at "
                  f"{FULL.mesh_spec(mesh).shape}: SKIP ({skip})")
            continue
        dryrun_cell_line(art)
    print(f"[dryrun] full decode_32k cells (both meshes) and the ties' "
          f"traces read {time.perf_counter() - t0:.1f} s after [graph]")
    ex = started[0]
    futures["late"] = {cell: ex.submit(run_cell, FULL, *cell)
                       for cell in DRYRUN_TRAIN_CELLS}
    futures["late"]["pp"] = ex.submit(lower_pp)
    return traces


def dryrun_late(started, futures):
    """``[dryrun]``'s cells read last, before ``[sharded]``:
    chatglm3-6b's ``train_4k`` at (16, 16) and (2, 16, 16) (their
    collective terms side by side: the pod sum crosses the network) and
    ``lower_pp``'s default cell (chatglm3-6b, (4, 8, 8), 8 x 32 x 4096),
    written under ``chiprun_out/dryrun/``; the workers stop."""
    ex, t0 = started[0], time.perf_counter()
    late = futures["late"]
    try:
        arts = {k: f.result() for k, f in late.items()}
    finally:
        ex.shutdown()
    pp = arts.pop("pp")
    for (arch, shape, mesh), art in arts.items():
        dryrun_write(art, "full", f"{arch}__{shape}__{mesh}.json")
        check(art["status"] == "OK", f"[dryrun] {arch}/{shape}/{mesh}: "
              f"{art['status']} {art.get('error', '')}")
        dryrun_cell_line(art)
    one, pod = (arts[c] for c in DRYRUN_TRAIN_CELLS)
    print(f"[dryrun] chatglm3-6b/train_4k collective terms, (16, 16) vs "
          f"(2, 16, 16): " + "; ".join(
              f"{k} {one['collectives'][k]:.6g} vs {pod['collectives'][k]:.6g}"
              f" B" for k in ("all-reduce", "all-gather", "total"))
          + f"; by link {one['collectives']['by_link']} vs "
          f"{pod['collectives']['by_link']}; collective "
          f"{one['roofline']['collective_s'] * 1e3:.4f} vs "
          f"{pod['roofline']['collective_s'] * 1e3:.4f} ms; calls "
          f"{one['collective_calls']} vs {pod['collective_calls']}")
    dryrun_write(pp, "pp", "chatglm3-6b__pp__stage4.json")
    check(pp["status"] == "OK", f"[dryrun] pp: {pp}")
    r, mem = pp["roofline"], pp["memory"]
    hbm = H100_SXM.hbm_bytes
    print(f"[dryrun] pp {pp['arch']} {pp['mesh']}, {pp['n_micro']} "
          f"microbatches of {pp['microbatch']} x {pp['seq_len']}: per-rank "
          f"peak {mem['peak_bytes']} B ({mem['peak_bytes'] / hbm:.3f} of "
          f"{hbm:.0f} B: "
          f"{'fits' if mem['peak_bytes'] <= hbm else 'does not fit'}), "
          f"arguments {mem['argument_bytes']} "
          f"B ({pp['memory_gb_per_chip']} GiB), flops "
          f"{pp['flops_per_chip']:.6g}, collective-permute "
          f"{pp['collectives']['collective-permute']:.6g} B, all "
          f"collectives {pp['collectives']['total']:.6g} B; bubble "
          f"{pp['bubble_fraction']:.4f}; compute {r['compute_s'] * 1e3:.4f}"
          f" ms, memory {r['memory_s'] * 1e3:.4f} ms, collective "
          f"{r['collective_s'] * 1e3:.4f} ms, dominant {r['dominant']}; "
          f"{pp['trace_s']:.1f} s")
    print(f"[dryrun] train and pp cells read "
          f"{time.perf_counter() - t0:.1f} s before [sharded]")


def tie_item(traces, name, params, cfg):
    """The [sharded] item of tie ``name`` (:func:`tie_specs`) on
    ``params`` and ``cfg`` (the spawn's own model), its dry traces
    ``traces[name]``."""
    from repro_torch.dist.sharding import get_recipe
    t = tie_specs()[name]
    check(cfg.name == t["arch"] and cfg.n_layers == t["layers"],
          f"[dryrun] tie {name}: spawn model {cfg.name} x {cfg.n_layers}")
    recipe = None if t["recipe"] is None else get_recipe(t["recipe"])
    return dict(kind="tie", title=f"[dryrun] tie {name}", cfg=cfg,
                params=params, mesh=t["mesh"], axes=t["axes"],
                recipe=recipe,
                runs=[dict(label=label, shape=shape, rt=rt, recipe=recipe,
                           mesh=(t["mesh"], t["axes"]), dry=dry)
                      for (label, shape, rt), dry in zip(t["runs"],
                                                         traces[name])])


def tie_rank(mesh, params, cfg, runs):
    """One rank of a tie: each run's step once on the tie's mesh (the
    spawn's, or one made over its ranks: every rank makes it), through
    ``lowering.live_step`` or, with no recipe, ``dryrun_pp.live_pp_step``
    (the collective counters set to 0 just before it, the peak over it),
    every launch count set to 0 before it and read after."""
    import torch
    from repro_torch.launch.dryrun_pp import live_pp_step
    from repro_torch.launch.lowering import live_step
    from repro_torch.launch.mesh import make_mesh
    counters = kernel_counters()
    take_cublas_workspace(mesh.device)
    meshes = {(tuple(mesh.axis_sizes), tuple(mesh.axis_names)): mesh}
    out = []
    for run in runs:
        gc.collect()
        torch.cuda.empty_cache()
        if run["mesh"] not in meshes:
            meshes[run["mesh"]] = make_mesh(*run["mesh"],
                                            devices=str(mesh.device))
        tm = meshes[run["mesh"]]
        for c in counters.values():
            c.launches = 0
        if run["recipe"] is None:
            rec = live_pp_step(tm, cfg, run["rt"], *run["shape"], params,
                               return_grads=False)
        else:
            rec = live_step(tm, cfg, run["shape"], run["recipe"], run["rt"],
                            params)
        rec.update(label=run["label"],
                   launches={k: c.launches for k, c in counters.items()})
        out.append(rec)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dry_traces(params, cfg, runs):
    """A tie's host side: each run's dry traces, made in [dryrun]."""
    return [run["dry"] for run in runs]


def tie_check(item, mesh, ranks, want):
    """Every rank of a tie (on the tie's own mesh, ``item["mesh"]``):
    its collective counters equal to its dry trace's records (kind,
    group size, calls, bytes; and kind, axis, group size, calls, bytes),
    its argument bytes equal to the trace's and, but for the PP step, to
    the capacity model's (``capacity`` under the tie's recipe: the
    closed form, not the placement code the two share), the trace's
    peak within ``DRYRUN_PEAK_TOL`` of the rank's
    ``max_memory_allocated``, its kernel launches equal to the trace's
    kernel nodes; each run's line beside the capacity model's figure.
    Returns the launches summed over ranks and runs."""
    from repro_torch.analysis.capacity import capacity
    cfg, shape_ = item["cfg"], item["mesh"]
    sizes = dict(zip(item["axes"], shape_))
    total = {}
    for i, run in enumerate(item["runs"]):
        shape = run["shape"]
        rep = None if run["recipe"] is None else capacity(
            cfg, shape, mesh=sizes, recipe=run["recipe"])
        peaks, rels = [], []
        for rank, (recs, dry) in enumerate(zip(ranks, want[i])):
            got = recs[i]
            what = f"{item['title']} {run['label']} rank {rank}"
            check(got["counts"] and got["counts"] == dry["counts"]
                  and got["axis_counts"] == dry["axis_counts"],
                  f"{what}: collectives {got['axis_counts']}, dry records "
                  f"{dry['axis_counts']}")
            args = dry["memory"]["argument_bytes"]
            check(got["argument_bytes"] == args and (
                rep is None or args == rep.argument_bytes),
                  f"{what}: arguments {got['argument_bytes']} B, dry "
                  f"{args} B, capacity model "
                  f"{rep and rep.argument_bytes} B")
            live, walk = got["peak_bytes"], dry["memory"]["peak_bytes"]
            rel = abs(walk - live) / live
            check(rel <= DRYRUN_PEAK_TOL, f"{what}: dry peak {walk} B vs "
                  f"max_memory_allocated {live} B ({rel:.3f} > "
                  f"{DRYRUN_PEAK_TOL})")
            launched = {k: v for k, v in got["launches"].items() if v}
            check(launched == dry["kernels"], f"{what}: launches "
                  f"{launched}, dry kernel nodes {dry['kernels']}")
            peaks.append((walk, live))
            rels.append(rel)
            for k, n in got["launches"].items():
                total[k] = total.get(k, 0) + n
        r0 = ranks[0][i]
        print(f"{item['title']} {run['label']} at {shape_} over "
              f"{item['axes']} under "
              f"{run['recipe'].name if rep else 'dryrun_pp'}: every rank's "
              f"collectives == its dry records (rank 0 "
              f"{r0['axis_counts']}); arguments "
              f"{r0['argument_bytes']} B == dry"
              f"{' == the capacity model' if rep else ''}'s; peak dry vs "
              f"max_memory_allocated per rank {peaks} B (worst |d|/live "
              f"{max(rels):.3f}, bar {DRYRUN_PEAK_TOL}); capacity model "
              f"peak {rep.peak_bytes if rep else 'n/a'} B; launches == "
              f"kernel nodes on every rank (rank 0 {want[i][0]['kernels']})"
              f"; {smi_line()}")
    return total


# ===========================================================================
# [sharded]: serving on a mesh of ranks that share the card
# ===========================================================================
#: New tokens of each served [serve] prompt on a mesh (the one-device
#: runs of [serve] take NEW_TOKENS): every step of a shared-card mesh
#: crosses gloo once a layer and a half, through host memory.
SHARDED_NEW = 8
#: Teacher-forced prompts: each prefills SHARDED_PREFILL tokens (the
#: scheduler's one bucket), then SHARDED_FORCED decode steps feed the
#: rest, every slot's logits captured at each.
SHARDED_PREFILL, SHARDED_FORCED = 300, 8
#: Seconds one mesh's spawn may take, its runs included.
SHARDED_TIMEOUT = 600
#: A rank's transient allocations over its parameters and cache, beside
#: its largest parameter block: the caching allocator rounds every block
#: up to 512 B, and a smoke-size step holds a few hundred small tensors
#: (a full-width rank's largest block, 0.5-0.8 GB, dwarfs it).
SHARDED_SLACK = 2 ** 20
#: Depth of a [sharded] model cut to make room for [sharded-train] in the
#: run's time limit: minicpm-2b's eight (1, 2) runs, the phase's longest
#: (a shared-card step crosses gloo one and a half times a layer), at 6
#: of its 40 layers, and chatglm3-6b's (1, 4) runs at 7 of its 28;
#: widths uncut.
SHARDED_LAYERS = {"minicpm-2b": 6, "chatglm3-6b": 7}
#: Depths of [sharded]'s MoE, SSM, hybrid and audio models (widths
#: uncut): zamba2-2.7b's 12 of 54 are two groups, so both of its
#: physical shared blocks run.
SHARDED_FAMILY_LAYERS = {"qwen2-moe-a2.7b": 4, "mamba2-1.3b": 8,
                         "zamba2-2.7b": 12, "hubert-xlarge": 8}
#: The kernels each mesh's runs must launch on every rank.
SHARDED_KERNELS = ("rmsnorm", "flash_attention", "decode_attention",
                   "paged_decode_attention", "quant_decode_attention",
                   "quant_paged_decode_attention")


def kernel_counters():
    """Every kernel wrapper by its name; each counts its launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import grouped_gemm_padded
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_matmul,
                                           quant_paged_decode_attention)
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "quant_decode_attention": quant_decode_attention,
            "quant_paged_decode_attention": quant_paged_decode_attention,
            "moe_gemm": grouped_gemm_padded, "ssd_scan": ssd_scan,
            "quant_matmul": quant_matmul}


def take_cublas_workspace(device) -> None:
    """cuBLAS takes its workspace (about 32 MiB on the card) from the
    caching allocator at a process's first product and keeps it: taken
    here, before any peak is measured."""
    import torch
    for dt in (torch.float32, torch.bfloat16):
        x = torch.ones(8, 8, device=device, dtype=dt)
        (x @ x).sum().item()


def recorded_routes(routes):
    """A context in which every MoE routing call appends its expert
    choices (T, K) to ``routes``, on the host."""
    import contextlib
    from repro_torch.models import moe as MOE

    @contextlib.contextmanager
    def ctx():
        route = MOE._route

        def recording(p, xt, c, dpl=None):
            g, idx, aux = route(p, xt, c, dpl)
            routes.append(idx.cpu())
            return g, idx, aux
        MOE._route = recording
        try:
            yield routes
        finally:
            MOE._route = route
    return ctx()


def mesh_run(make, run):
    """One run of [sharded] through the engine ``make(scheduler)``
    builds: ``run['requests']`` served; with ``run['teacher']`` the
    logits of every prefill and of every decode step captured as the
    host samples them (the requests then end after their forced tail),
    with ``run['routes']`` every MoE routing call's expert choices.
    Returns the tokens, the captured logits and routes, the step times,
    the stats and the engine's bytes."""
    import contextlib
    import torch
    from repro_torch.serve import Request, Scheduler
    sched = Scheduler(cfg=run["cfg"], max_len=run["kw"]["max_len"],
                      buckets=run.get("buckets"))
    eng = make(sched)
    caught = []
    if run.get("teacher"):
        host = eng._host_logits

        def capture(logits, prefill=False):
            arr = host(logits, prefill)
            caught.append(arr)
            return arr
        eng._host_logits = capture
    for r in run["requests"]:
        eng.submit(Request(**r))
    steps, routes = [], []
    with (recorded_routes(routes) if run.get("routes")
          else contextlib.nullcontext()):
        while eng.queue or any(s is not None for s in eng.slots):
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
    check(len(eng.finished) == len(run["requests"]) and not eng.rejected,
          f"{run['label']}: served {len(eng.finished)}")
    from repro_torch.tree import tree_leaves
    leaves = [t.numel() * t.element_size() for t in tree_leaves(eng.params)]
    return dict(tokens={r.rid: list(r.out_tokens) for r in eng.finished},
                logits=caught, routes=routes, steps_ms=steps,
                prefix_hits=eng.stats.prefix_hits,
                params_bytes=tree_bytes(eng.params),
                cache_bytes=tree_bytes(eng.cache), largest_leaf=max(leaves),
                gathered=0 if not hasattr(eng, "placement") else
                largest_gather(eng.cfg, eng.recipe, eng.placement.sizes,
                               eng.rt))


def largest_gather(cfg, recipe, sizes, rt) -> int:
    """The most bytes a rank holds gathered over ``data`` at once under
    ``recipe`` on a mesh of ``sizes``, host only: one block's leaves that
    the recipe splits over ``data``, whole (a layer of the stack, a
    hybrid's shared block), or the embedding or the head, at the dtypes
    ``rt`` casts them to; 0 where nothing is split over ``data``."""
    from repro_torch.dist.sharding import Placement
    from repro_torch.models.model import leaf_dtype, param_defs
    pl, n = Placement(cfg, recipe, sizes), sizes.get("data", 1)

    def whole(d, path, layers):
        if isinstance(d, dict):
            return sum(whole(v, path + (k,), layers) for k, v in d.items())
        if pl.split_dim(d.axes, d.shape) is None:
            return 0
        return (math.prod(pl.local_shape(d.axes, d.shape)) * n
                * leaf_dtype(path, rt).itemsize // layers)
    layers = {"blocks": cfg.n_layers, "shared": cfg.n_shared_attn_blocks}
    return max(whole(d, (k,), layers.get(k, 1))
               for k, d in param_defs(cfg).items())


def sharded_rank(mesh, params, cfg, runs):
    """One rank of a [sharded] mesh (``run_mesh`` spawns it; the parent
    built the kernel library, this process loads it): each run on this
    rank's blocks of ``params`` (the parent's tensors, read over CUDA
    IPC), every launch count set to 0 before it and read after, the
    rank's peak since the engine was built. Rank 0 returns the captured
    logits."""
    import torch
    from repro_torch.serve import (ShardedPagedServeEngine,
                                   ShardedServeEngine)
    counters = kernel_counters()
    take_cublas_workspace(mesh.device)
    out = []
    for run in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        cls = ShardedPagedServeEngine if run["paged"] \
            else ShardedServeEngine
        rec = mesh_run(lambda sched: cls(params, cfg, run["rt"], mesh,
                                         scheduler=sched,
                                         recipe=run.get("recipe"),
                                         **run["kw"]), run)
        torch.cuda.synchronize()
        rec.update(rank=mesh.rank, backend=mesh.backend,
                   coords=dict(mesh.coords), label=run["label"],
                   peak=torch.cuda.max_memory_allocated() - base,
                   launches={k: c.launches for k, c in counters.items()})
        if mesh.rank != 0:
            rec["logits"] = rec["routes"] = None
        out.append(rec)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sharded_runs(cfg, rt, *, teacher: bool, served, kvs=(None,),
                 layouts=(False, True), n_slots=4, max_len=1024, page=16,
                 forced_steps=SHARDED_FORCED, recipe=None):
    """The run list of one mesh: per KV dtype and layout (contiguous,
    paged), a teacher-forced run (``n_slots`` prompts of SHARDED_PREFILL
    + ``forced_steps`` tokens) when ``teacher``, and ``served``'s requests;
    every run under ``recipe`` (a name; None: the engine's default)."""
    import dataclasses
    import numpy as np
    runs = []
    rng = np.random.default_rng(17)
    forced = [dict(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, SHARDED_PREFILL + forced_steps).astype(
            np.int32), max_new_tokens=1) for i in range(n_slots)]
    for kv in kvs:
        run_rt = dataclasses.replace(rt, kv_dtype=kv)
        for paged in layouts:
            kw = dict(n_slots=n_slots, max_len=max_len)
            if paged:
                kw["page_size"] = page
            name = (f"{'paged' if paged else 'contiguous'} "
                    f"{kv or rt.dtype}")
            base = dict(cfg=cfg, rt=run_rt, paged=paged, kw=kw,
                        recipe=recipe, forced=forced_steps)
            if teacher:
                runs.append(dict(base, label=f"{name} teacher-forced",
                                 teacher=True, requests=forced,
                                 buckets=(SHARDED_PREFILL,)))
            runs.append(dict(base, label=f"{name} served",
                             requests=served))
    return runs


def one_device_runs(params, cfg, runs):
    """The same runs through the one-device engines (the reference the
    mesh is held to; their launches count on no path)."""
    from repro_torch.serve import PagedServeEngine, ServeEngine
    out = []
    for run in runs:
        cls = PagedServeEngine if run["paged"] else ServeEngine
        out.append(mesh_run(lambda sched: cls(params, cfg, run["rt"],
                                              scheduler=sched, **run["kw"]),
                            run))
    return out


def sharded_mesh(title, mesh, cfg, params, runs, expect, logit_tol=None,
                 equal_tokens=False):
    """One mesh of [sharded]: the runs on every rank, each held to the
    one-device engine's (logits within ``logit_tol``, or tokens equal),
    every rank's bytes to the capacity prediction, its peak to that
    plus its largest leaf, and ``expect``'s kernels launched on every
    rank. Returns the launches summed over ranks and runs."""
    return sharded_spawn(mesh, [dict(
        kind="serve", title=title, cfg=cfg, params=params, runs=runs,
        expect=expect, logit_tol=logit_tol, equal_tokens=equal_tokens)])


def sharded_items_rank(mesh, items):
    """One rank of a [sharded] mesh that runs several models: each item
    ``(kind, params, cfg, runs)`` in turn, ``serve`` as ``sharded_rank``
    serves, ``forward`` as ``forward_rank`` runs, ``moe_layer`` as
    ``moe_layer_rank`` does."""
    ranks = {"serve": sharded_rank, "forward": forward_rank,
             "moe_layer": moe_layer_rank, "tie": tie_rank}
    return [ranks[kind](mesh, params, cfg, runs)
            for kind, params, cfg, runs in items]


#: bf16's unit roundoff: the expert-split layer's bar is (M + 2) of it
#: times max|one device| (``moe_layer_check``).
BF16_U = 2.0 ** -8


def _moe_layer_params(layer, cfg, dtype):
    """One MoE layer's weights in ``dtype``, but the f32 leaves (router,
    shared gate)."""
    import torch
    from repro_torch.models.model import F32_LEAVES
    return {k: v.to(torch.float32 if k in F32_LEAVES else dtype)
            for k, v in layer.items()}


def moe_layer_rank(mesh, layer, cfg, runs):
    """One rank's MoE FFN (dropless, the cuda policy) on its block of
    ``layer`` (one layer's weights, whole, the parent's tensors over CUDA
    IPC) under the decode recipe, in bf16, on each run's ``x``, the same
    on every rank: the output summed over ``model``, and the launches
    (counts set to 0 before each run)."""
    import torch
    from repro_torch.dist.sharding import DECODE_RECIPE, shard_tree
    from repro_torch.models.model import F32_LEAVES
    from repro_torch.models.moe import moe_defs, moe_ffn
    counters = kernel_counters()
    axes = {k: d.axes for k, d in moe_defs(cfg).items()}
    p = shard_tree(layer, axes, DECODE_RECIPE, mesh, cfg,
                   dtype=lambda path: torch.float32 if any(
                       f"'{n}'" in path for n in F32_LEAVES)
                   else torch.bfloat16)
    pl = mesh.placement(cfg, DECODE_RECIPE)
    out = []
    for run in runs:
        for c in counters.values():
            c.launches = 0
        with torch.no_grad():
            y, _ = moe_ffn(p, run["x"].to(mesh.device), cfg, dropless=True,
                           pl=pl)
        torch.cuda.synchronize()
        out.append(dict(rank=mesh.rank, split=pl.moe_split,
                        columns=tuple(p["wo"].shape),
                        out=y.cpu() if mesh.rank == 0 else None,
                        launches={k: c.launches
                                  for k, c in counters.items()}))
    return out


def one_device_moe_layer(layer, cfg, runs):
    """The same layer on one device, in bf16 and in f32 (the cuda
    policy), each run's outputs on the host."""
    import torch
    from repro_torch.models.moe import moe_ffn
    out = []
    for run in runs:
        rec = {}
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            with torch.no_grad():
                y, _ = moe_ffn(_moe_layer_params(layer, cfg, dt),
                               run["x"].to("cuda", dt), cfg, dropless=True)
            rec[name] = y.float().cpu()
        out.append(rec)
    return out


def moe_layer_check(item, mesh, ranks, want):
    """The expert-split layer against one device, with the same x on every
    rank (the router whole on each: the routing is the same by
    construction, so only rounding separates them). Each rank's ``wo``
    product leaves the grouped GEMM rounded to bf16 (at most u = 2^-8 of
    it, a product taken at one output's worth), the M partials are
    summed in f32, one device rounds its product and its gate-weighted
    sum once each: the bar is (M + 2) u max|one device|. The mesh must
    also be no further from the f32 layer than one device is, give or
    take u max|one device|."""
    title, M = item["title"], mesh[1]
    tag = item.get("tag", "[sharded]")
    total = {}
    for i, run in enumerate(item["runs"]):
        recs = [r[i] for r in ranks]
        got, ref, exact = recs[0]["out"].float(), want[i]["bf16"], \
            want[i]["f32"]
        check({r["split"] for r in recs} == {"ffn"},
              f"{title}: splits {[r['split'] for r in recs]}")
        check(got.shape == ref.shape and bool(got.isfinite().all()),
              f"{title} {run['label']}: output {tuple(got.shape)}")
        scale = float(ref.abs().max())
        dev = float((got - ref).abs().max())
        bar = (M + 2) * BF16_U * scale
        mesh_exact = float((got - exact).abs().max())
        one_exact = float((ref - exact).abs().max())
        print(f"{tag} {title} {run['label']}: {recs[0]['columns']} wo "
              f"block a rank, max |mesh - one device| {dev:.6f} = "
              f"{dev / (BF16_U * scale):.3f} u max|one device| "
              f"({scale:.4f}; bar (M + 2) u = {M + 2} u = {bar:.6f}); "
              f"against the f32 layer: mesh {mesh_exact:.6f}, one device "
              f"{one_exact:.6f} (bar one device + u max = "
              f"{one_exact + BF16_U * scale:.6f})")
        check(dev <= bar, f"{title} {run['label']}: {dev} past {bar}")
        check(mesh_exact <= one_exact + BF16_U * scale,
              f"{title} {run['label']}: {mesh_exact} from f32, one device "
              f"{one_exact}")
        for r in recs:
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
    launched_on(title, ranks, item["expect"], total, tag)
    return total


def forward_rank(mesh, params, cfg, runs):
    """``serve.sharded.mesh_forward`` on this rank (its blocks of the
    parent's tensors, read over CUDA IPC), every launch count set to 0
    before each run and read after, the rank's peak since it began.
    Rank 0 returns the logits."""
    import torch
    from repro_torch.serve.sharded import mesh_forward
    counters = kernel_counters()
    take_cublas_workspace(mesh.device)
    out = []
    for run in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        rec = mesh_forward(mesh, params, cfg, [run])[0]
        torch.cuda.synchronize()
        rec.update(label=run["label"], ms=(time.perf_counter() - t0) * 1e3,
                   peak=torch.cuda.max_memory_allocated() - base,
                   launches={k: c.launches for k, c in counters.items()})
        if mesh.rank != 0:
            rec["logits"] = None
        out.append(rec)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def one_device_forward(params, cfg, runs):
    """Each run's ``forward`` on one device (its logits on the host, its
    wall ms): the reference a mesh's forward is held to."""
    import torch
    from repro_torch.models import forward
    out = []
    for run in runs:
        batch = {k: torch.as_tensor(v).cuda() for k, v in run["batch"].items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = forward(params, cfg, batch, run["rt"])
        torch.cuda.synchronize()
        out.append(dict(logits=logits.float().cpu(),
                        ms=(time.perf_counter() - t0) * 1e3))
    return out


def sharded_spawn(mesh, items, tag="[sharded]"):
    """One [sharded] spawn of ``mesh`` running every item (a dict of
    ``kind`` ``serve`` or ``forward``, ``title``, ``cfg``, ``params``,
    ``runs``, ``expect`` and ``logit_tol`` (None: reported, not held),
    and for ``serve`` ``equal_tokens`` and ``same_bits_as``: the index
    of an earlier item whose teacher-forced logits, run for run, this
    item's must equal bit for bit), each held to its one-device runs,
    its lines printed under ``tag``. Returns the launches summed over
    ranks, items and runs."""
    import torch
    from repro_torch.launch.mesh import pick_backend, run_mesh
    t0 = time.perf_counter()
    ones = {"serve": one_device_runs, "forward": one_device_forward,
            "moe_layer": one_device_moe_layer, "tie": dry_traces}
    wants = [ones[it["kind"]](it["params"], it["cfg"], it["runs"])
             for it in items]
    t_one = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = run_mesh(sharded_items_rank, mesh,
                     [(it["kind"], it["params"], it["cfg"], it["runs"])
                      for it in items], timeout=SHARDED_TIMEOUT)
    t_mesh = time.perf_counter() - t0
    backend = pick_backend(len(ranks))
    print(f"{tag} {' + '.join(it['title'] for it in items)}: mesh "
          f"{mesh[0]}x{mesh[1]} (data, model), {len(ranks)} ranks on "
          f"{torch.cuda.device_count()} card(s) over "
          f"{backend} (all_reduce / all_gather / "
          f"broadcast of CUDA tensors, staged by gloo through host memory);"
          f" spawn and runs {t_mesh:.1f} s, one-device runs {t_one:.1f} s")
    total = {}
    for i, (it, want) in enumerate(zip(items, wants)):
        check_fn = {"serve": sharded_check, "forward": forward_check,
                    "moe_layer": moe_layer_check,
                    "tie": tie_check}[it["kind"]]
        got = check_fn(dict(it, tag=tag), mesh, [r[i] for r in ranks], want)
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        if it.get("same_bits_as") is not None:
            same_bits(tag, items, i, it["same_bits_as"], ranks)
    return total


def same_bits(tag, items, i, j, ranks):
    """Item ``i``'s teacher-forced logits against item ``j``'s on rank 0,
    run for run: equal bit for bit, else the largest difference printed
    and the run failed."""
    import numpy as np
    a_item, b_item = items[i], items[j]
    for k, run in enumerate(a_item["runs"]):
        if not run.get("teacher"):
            continue
        a, b = ranks[0][i][k]["logits"], ranks[0][j][k]["logits"]
        same = len(a) == len(b) and all(
            x.shape == y.shape and x.tobytes() == y.tobytes()
            for x, y in zip(a, b))
        dev = max(float(np.abs(x.astype(np.float64) - y).max())
                  for x, y in zip(a, b))
        print(f"{tag} {a_item['title']} vs {b_item['title']} "
              f"{run['label']}: {len(a)} logits arrays "
              f"{'equal bit for bit' if same else 'NOT equal bit for bit'}"
              f" (max |difference| {dev})")
        check(same, f"{a_item['title']} {run['label']}: logits differ from "
              f"{b_item['title']}'s by up to {dev}")


def sharded_check(item, mesh, ranks, want):
    """The serving runs of one item against the one-device engine's
    (``want``): logits within the item's ``logit_tol`` (reported when it
    is None), or tokens equal; every rank's bytes equal to
    ``serve_preflight(mesh=..., recipe=...)``, its peak at most that plus
    its largest leaf and, under a recipe that splits weights over
    ``data``, the largest layer it gathers; the item's kernels launched
    on every rank and no other."""
    import numpy as np
    from repro_torch.analysis.capacity import serve_preflight
    title, cfg, runs = item["title"], item["cfg"], item["runs"]
    tag = item.get("tag", "[sharded]")
    logit_tol, expect = item["logit_tol"], item["expect"]
    sizes = {"data": mesh[0], "model": mesh[1]}
    total = {}
    for i, run in enumerate(runs):
        recs = [r[i] for r in ranks]
        rank0, ref = recs[0], want[i]
        for r in recs[1:]:
            check(r["tokens"] == rank0["tokens"], f"{title} {run['label']}:"
                  f" rank {r['rank']} served other tokens than rank 0")
        line = f"{tag} {title} {run['label']}:"
        if run.get("teacher"):
            dev = max(float(np.abs(a - b).max())
                      for a, b in zip(rank0["logits"], ref["logits"]))
            check(len(rank0["logits"]) == len(ref["logits"])
                  == len(run["requests"]) + run["forced"],
                  f"{title} {run['label']}: captured "
                  f"{len(rank0['logits'])} logits")
            a = np.concatenate([x.argmax(-1) for x in rank0["logits"]])
            b = np.concatenate([x.argmax(-1) for x in ref["logits"]])
            line += (f" logits of {len(run['requests'])} prefills + "
                     f"{run['forced']} decode steps, max |mesh - one "
                     f"device| {dev:.4f} (tol "
                     f"{'none: reported' if logit_tol is None else logit_tol}"
                     f"); argmax agree {int((a == b).sum())}/{a.size}; "
                     f"step p50 {statistics.median(rank0['steps_ms']):.2f} "
                     f"ms (one device "
                     f"{statistics.median(ref['steps_ms']):.2f} ms)")
            if run.get("routes"):
                check(len(rank0["routes"]) == len(ref["routes"]) > 0,
                      f"{title} {run['label']}: routing calls "
                      f"{len(rank0['routes'])} vs {len(ref['routes'])}")
                same = sum(int((x == y).sum()) for x, y in
                           zip(rank0["routes"], ref["routes"]))
                n = sum(x.numel() for x in ref["routes"])
                line += (f"; routing agree {same}/{n} (token, k) "
                         f"choices")
            if logit_tol is not None:
                check(dev <= logit_tol, f"{title} {run['label']}: logits "
                      f"{dev:.4f} from one device, tol {logit_tol}")
        else:
            same = sum(x == y for rid in ref["tokens"]
                       for x, y in zip(rank0["tokens"][rid],
                                       ref["tokens"][rid]))
            n = sum(len(v) for v in ref["tokens"].values())
            line += (f" tokens equal to one device at {same}/{n}; step p50 "
                     f"{statistics.median(rank0['steps_ms']):.2f} ms (one "
                     f"device {statistics.median(ref['steps_ms']):.2f} ms) "
                     f"over {len(rank0['steps_ms'])} steps")
            if item.get("equal_tokens"):
                check(rank0["tokens"] == ref["tokens"], f"{title} "
                      f"{run['label']}: tokens differ from one device")
            if run["paged"]:
                line += (f"; prefix hits {rank0['prefix_hits']} (one "
                         f"device {ref['prefix_hits']})")
        rt = run["rt"]
        cap = serve_preflight(cfg, n_slots=run["kw"]["n_slots"],
                              max_len=run["kw"]["max_len"],
                              page_size=run["kw"].get("page_size"),
                              mesh=sizes, dtype=rt.dtype,
                              param_dtype=rt.dtype, kv_dtype=rt.kv_dtype,
                              recipe=run.get("recipe") or "decode")
        pred = cap.params_bytes + cap.cache_bytes
        for r in recs:
            check(r["params_bytes"] == cap.params_bytes
                  and r["cache_bytes"] == cap.cache_bytes,
                  f"{title} {run['label']} rank {r['rank']}: params "
                  f"{r['params_bytes']} B, cache {r['cache_bytes']} B, "
                  f"predicted {cap.params_bytes} and {cap.cache_bytes}")
            # a leaf's gather holds every rank's block beside their
            # concatenation: at most the layer twice
            bound = (pred + 2 * r["gathered"] + r["largest_leaf"]
                     + SHARDED_SLACK)
            check(r["peak"] <= bound, f"{title} {run['label']} rank "
                  f"{r['rank']}: peak {r['peak']} B past {pred} + 2 x "
                  f"gathered {r['gathered']} + {r['largest_leaf']} + "
                  f"{SHARDED_SLACK}")
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
        gathered = recs[0]["gathered"]
        line += (f"; per rank params {cap.params_bytes} B + cache "
                 f"{cap.cache_bytes} B = predicted")
        if gathered:
            with_layer = pred + gathered + SHARDED_SLACK
            line += (f"; peaks {[r['peak'] for r in recs]} B beside params "
                     f"+ cache + the largest gathered layer {gathered} B + "
                     f"{SHARDED_SLACK} B = {with_layer} B (peak - that: "
                     f"{[r['peak'] - with_layer for r in recs]} B; held "
                     f"<= that + the layer again, the gather's blocks "
                     f"beside their concatenation, + the largest leaf "
                     f"{recs[0]['largest_leaf']} B)")
        else:
            line += (f", peaks {[r['peak'] for r in recs]} B <= {pred} + "
                     f"largest leaf {recs[0]['largest_leaf']} B + "
                     f"{SHARDED_SLACK} B")
        print(line + f" (calibrated peak {cap.peak_bytes} B)")
    launched_on(title, ranks, expect, total, tag)
    return total


def launched_on(title, ranks, expect, total, tag="[sharded]"):
    """Every rank launched ``expect``'s kernels over its runs, and no
    other path's."""
    for rank in ranks:
        launched = {k for rec in rank for k, n in rec["launches"].items()
                    if n}
        check(set(expect) <= launched, f"{title}: rank {rank[0]['rank']} "
              f"launched {sorted(launched)}, not all of {sorted(expect)}")
        check(not launched - set(expect), f"{title}: rank "
              f"{rank[0]['rank']} launched another path's "
              f"{sorted(launched - set(expect))}")
    print(f"{tag} {title}: every rank launched {sorted(expect)}; "
          f"launches over ranks and runs "
          f"{ {k: v for k, v in total.items() if v} }")


def forward_check(item, mesh, ranks, want):
    """The forward runs of one item against one device's: logits within
    the item's ``logit_tol``; every rank's parameter bytes equal to
    ``capacity(prefill, mesh=...)``'s, the item's kernels launched on
    every rank and no other."""
    from repro_torch.analysis.capacity import capacity
    from repro_torch.configs.base import ShapeConfig
    title, cfg = item["title"], item["cfg"]
    sizes = {"data": mesh[0], "model": mesh[1]}
    total = {}
    for i, run in enumerate(item["runs"]):
        recs = [r[i] for r in ranks]
        ref = want[i]
        B, S = next(iter(run["batch"].values())).shape[:2]
        rep = capacity(cfg, ShapeConfig("prefill", S, B, "prefill"),
                       mesh=sizes, dtype=run["rt"].dtype)
        for r in recs:
            check(r["params_bytes"] == rep.params_bytes, f"{title} rank "
                  f"{r['rank']}: params {r['params_bytes']} B, predicted "
                  f"{rep.params_bytes}")
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
        got = recs[0]["logits"]
        check(got.shape == ref["logits"].shape and bool(
            got.isfinite().all()), f"{title}: logits {tuple(got.shape)}")
        dev = float((got - ref["logits"]).abs().max())
        agree = float((got.argmax(-1) == ref["logits"].argmax(-1))
                      .float().mean())
        check(dev <= item["logit_tol"], f"{title} {run['label']}: logits "
              f"{dev:.4f} from one device, tol {item['logit_tol']}")
        print(f"[sharded] {title} {run['label']} (recipe "
              f"{recs[0]['recipe']}): logits max |mesh - one device| "
              f"{dev:.4f} (tol {item['logit_tol']}), argmax agree "
              f"{agree:.4f}; {max(r['ms'] for r in recs):.1f} ms (one "
              f"device {ref['ms']:.1f}); per rank params "
              f"{rep.params_bytes} B = predicted, peaks "
              f"{[r['peak'] for r in recs]} B")
    launched_on(title, ranks, item["expect"], total)
    return total


def sharded_phase(counters, ties):
    """``[sharded]``: the sharded engines on meshes whose ranks share the
    card over gloo: full-width minicpm-2b (6 of 40 layers,
    ``SHARDED_LAYERS``) at (1, 2) in bf16 (contiguous
    and paged, bf16 and int8 KV), full-width chatglm3-6b (7 of 28
    layers) at (1, 4) in
    bf16 (its vocabulary split over the ranks, each rank holding the one
    K/V head of its 8 query heads), smoke minicpm-2b at (2, 4) in f32
    (tokens equal to one device, the prefix cache hit). The (1, 2)
    and (1, 4) models run in one spawn each with ``sharded_family_items``'
    of the same shape, each beside its [dryrun] tie (``ties``: the dry
    traces, :func:`dryrun_phase`). Returns the launches summed over every
    rank's runs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch.mesh import pick_backend
    from repro_torch.models import ModelRuntime, init_params

    t_phase = time.perf_counter()
    print(f"[sharded] backend rule: {torch.cuda.device_count()} card(s), "
          f"ranks 2/4/8 -> {pick_backend(2)}/{pick_backend(4)}/"
          f"{pick_backend(8)} (nccl only when every rank has a card: it "
          f"refuses two ranks on one device, 'Duplicate GPU detected')")
    totals, by_mesh = [], {(1, 2): [], (1, 4): []}
    rt = ModelRuntime()                   # bf16, cuda policy
    for name, mesh, kvs, layouts in (
            ("minicpm-2b", (1, 2), (None, "int8"), (False, True)),
            ("chatglm3-6b", (1, 4), (None,), (False,))):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_arch(name)
        cfg = dataclasses.replace(
            cfg, n_layers=SHARDED_LAYERS.get(name, cfg.n_layers))
        params = init_params(cfg, seed=0, rt=rt)    # cast leaf by leaf
        rng = np.random.default_rng(1)
        served = [dict(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                       .astype(np.int32), max_new_tokens=SHARDED_NEW)
                  for i, n in enumerate(PROMPT_LENS)]
        runs = sharded_runs(cfg, rt, teacher=True, served=served, kvs=kvs,
                            layouts=layouts)
        expect = {"rmsnorm", "flash_attention", "decode_attention"}
        if name == "minicpm-2b":
            expect = set(SHARDED_KERNELS)
        by_mesh[mesh].append(dict(
            kind="serve", title=f"{name} full width bf16", cfg=cfg,
            params=params, runs=runs, expect=expect, logit_tol=LOGIT_TOL))
        by_mesh[mesh].append(tie_item(ties, name, params, cfg))
        del params
    # smoke minicpm-2b in f32 at (2, 4): the reference test's prompts
    gc.collect()
    torch.cuda.empty_cache()
    cfg = smoke_config(get_arch("minicpm-2b"))
    f32 = ModelRuntime(dtype="float32")
    params = init_params(cfg, seed=0, device="cuda")
    contiguous = [dict(rid=i, prompt=(np.arange(3 + i) * 3 + i).astype(
        np.int32) % cfg.vocab_size, max_new_tokens=6) for i in range(6)]
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, 16)
    shared = [dict(rid=i, prompt=np.concatenate([system, rng.integers(
        0, cfg.vocab_size, 3 + i)]).astype(np.int32), max_new_tokens=6)
        for i in range(6)]
    runs = (sharded_runs(cfg, f32, teacher=False, served=contiguous,
                         layouts=(False,), max_len=64, page=8)
            + sharded_runs(cfg, f32, teacher=False, served=shared,
                           layouts=(True,), max_len=64, page=8))
    totals.append(sharded_mesh(
        "smoke minicpm-2b f32", (2, 4), cfg, params, runs,
        {"rmsnorm", "flash_attention", "decode_attention",
         "paged_decode_attention"}, equal_tokens=True))
    del params
    for mesh, items in sharded_family_items(ties).items():
        totals.append(sharded_spawn(mesh, by_mesh.get(mesh, []) + items))
    del by_mesh, items
    mixtral_preflight()
    sharded = {k: sum(t.get(k, 0) for t in totals) for k in counters}
    print(f"[sharded] launches over all meshes {sharded}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return sharded


def sharded_family_items(ties):
    """[sharded]'s MoE, SSM, hybrid and audio items (widths uncut,
    depths ``SHARDED_FAMILY_LAYERS``): qwen2-moe-a2.7b at (1, 4), 15
    experts a rank, in f32 (teacher-forced on the contiguous engine: its
    logits within ``LOGIT_TOL``, its argmax and routing agreement; the
    [serve] prompts on the paged engine: tokens equal to one device's)
    and in bf16 (teacher-forced: the deviation, argmax and routing
    agreement reported, routing flips in bf16); in one (1, 2) spawn mamba2-1.3b (32 SSD heads a
    rank) and zamba2-2.7b (40 heads and 16 attention heads a rank)
    teacher-forced in bf16 and hubert-xlarge's forward (B 2, S 1024
    frames, bf16), logits within ``LOGIT_TOL`` of one device; qwen2-moe's
    [dryrun] tie beside its items. Returns the items of each mesh, for
    ``sharded_spawn``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import ModelRuntime, init_params

    def model(name):
        return dataclasses.replace(get_arch(name),
                                   n_layers=SHARDED_FAMILY_LAYERS[name])

    def served(cfg):
        rng = np.random.default_rng(1)
        return [dict(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                     .astype(np.int32), max_new_tokens=SHARDED_NEW)
                for i, n in enumerate(PROMPT_LENS)]

    bf16, f32 = ModelRuntime(), ModelRuntime(dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = model("qwen2-moe-a2.7b")
    params = init_params(cfg, seed=0, device="cuda")          # f32
    every = sharded_runs(cfg, f32, teacher=True, served=served(cfg))
    runs32 = [dict(every[0], routes=True), every[3]]  # teacher, paged
    runs16 = [dict(run, routes=True) for run in sharded_runs(
        cfg, bf16, teacher=True, served=[], layouts=(False,))[:1]]
    expect = {"rmsnorm", "flash_attention", "decode_attention", "moe_gemm"}
    moe = [dict(kind="serve", title=f"qwen2-moe-a2.7b ({cfg.n_layers} of 24 "
                f"layers) f32", cfg=cfg, params=params, runs=runs32,
                expect=expect | {"paged_decode_attention"},
                logit_tol=LOGIT_TOL, equal_tokens=True),
           dict(kind="serve", title=f"qwen2-moe-a2.7b ({cfg.n_layers} of 24 "
                f"layers) bf16", cfg=cfg, params=params, runs=runs16,
                expect=expect, logit_tol=None),
           tie_item(ties, "qwen2-moe-a2.7b", params, cfg)]
    del params
    split = expert_split_items(bf16, expect, ties)
    items = []
    for name, expect in (
            ("mamba2-1.3b", {"rmsnorm", "ssd_scan"}),
            ("zamba2-2.7b", {"rmsnorm", "ssd_scan", "flash_attention",
                             "decode_attention"})):
        cfg = model(name)
        items.append(dict(
            kind="serve", title=f"{name} ({cfg.n_layers} of "
            f"{get_arch(name).n_layers} layers) bf16", cfg=cfg,
            params=init_params(cfg, seed=0, rt=bf16),
            runs=sharded_runs(cfg, bf16, teacher=True, served=[],
                              layouts=(False,))[:1],
            expect=expect, logit_tol=LOGIT_TOL))
    cfg = model(ENCODER)
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, 1024, cfg.d_model)).astype(np.float32)
    items.append(dict(
        kind="forward", title=f"{ENCODER} ({cfg.n_layers} of "
        f"{get_arch(ENCODER).n_layers} layers) bf16 forward", cfg=cfg,
        params=init_params(cfg, seed=0, rt=bf16),
        runs=[dict(label="B 2 S 1024 frames", rt=bf16,
                   batch={"embeds": frames})],
        expect={"flash_attention"} | ({"rmsnorm"} if uses_rmsnorm(cfg)
                                      else set()),
        logit_tol=LOGIT_TOL))
    return {(1, 4): moe, (1, 2): items, (1, 8): split}


#: Depth of the expert-split qwen2-moe-a2.7b at (1, 8) (widths uncut).
SPLIT_LAYERS = 2
#: The expert-split layer's inputs, the same on every rank: 4 decode
#: slots, and a 1024-token prefill.
SPLIT_LAYER_X = (("decode B 4", (4, 1)), ("prefill B 1 S 1024", (1, 1024)))


def expert_split_items(bf16, expect, ties):
    """[sharded]'s (1, 8) spawn: qwen2-moe-a2.7b's 60 experts do not
    divide over ``model`` 8, so every expert splits its 1,408 columns,
    176 a rank (expert-split). Layer 0's MoE FFN in bf16 with the same x
    on every rank, held to one device (``moe_layer_check``), then the
    model at ``SPLIT_LAYERS`` layers teacher-forced in bf16 (its logits'
    deviation from one device reported, not held: routing flips), then
    its [dryrun] tie on a (pod, data, model) mesh of (2, 2, 2) over the
    same ranks (30 experts a rank, the slots over pod x data)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b"),
                              n_layers=SPLIT_LAYERS)
    params = init_params(cfg, seed=0, device="cuda")          # f32
    layer = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    rng = np.random.default_rng(11)
    runs = [dict(label=label, x=torch.as_tensor(rng.standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)).to(torch.bfloat16))
        for label, shape in SPLIT_LAYER_X]
    teacher = [dict(run, routes=True) for run in sharded_runs(
        cfg, bf16, teacher=True, served=[], layouts=(False,))[:1]]
    return [dict(kind="moe_layer", title="qwen2-moe-a2.7b layer 0 MoE FFN "
                 "expert-split bf16", cfg=cfg, params=layer, runs=runs,
                 expect={"moe_gemm"}),
            dict(kind="serve", title=f"qwen2-moe-a2.7b ({cfg.n_layers} of 24"
                 f" layers) expert-split bf16", cfg=cfg, params=params,
                 runs=teacher, expect=expect, logit_tol=None),
            tie_item(ties, "qwen2-moe-a2.7b pod", params, cfg)]


def mixtral_preflight():
    """[sharded]'s last line: mixtral-8x22b's serving preflight at
    (1, 8), host only (its 282 GB of bf16 weights fit no card)."""
    from repro_torch.analysis.capacity import serve_preflight
    from repro_torch.configs import get_arch
    cfg = get_arch("mixtral-8x22b")
    sizes = {"data": 1, "model": 8}
    one = serve_preflight(cfg, n_slots=4, max_len=1024, dtype="bfloat16")
    rep = serve_preflight(cfg, n_slots=4, max_len=1024, mesh=sizes,
                          dtype="bfloat16")
    check(rep.fits and not one.fits, f"mixtral-8x22b preflight: mesh "
          f"{rep.fits}, one card {one.fits}")
    print(f"[sharded] mixtral-8x22b full width at (1, 8) under "
          f"{rep.recipe}, 4 slots x 1024, host only: per rank params "
          f"{rep.params_bytes} B (one expert of 8) + cache "
          f"{rep.cache_bytes} B, predicted peak {rep.peak_bytes} B of "
          f"{rep.hbm_bytes} B: fits; one card would hold params "
          f"{one.params_bytes} B: does not")


# ===========================================================================
# [sharded-zero3]: serving with the weights split over data
# ===========================================================================
#: Depths of the full-width models [sharded-zero3] serves (widths uncut):
#: every step of a shared-card mesh gathers each layer over gloo, through
#: host memory; qwen2-moe cut from 4 to 2 to make room for [graph] in the
#: run's time limit (a 1.1 GB f32 layer gathered a pass), then to 1 for
#: the pod axis's ties.
ZERO3_LAYERS = {"chatglm3-6b": 4, "qwen2-moe-a2.7b": 1}
#: The slots of a [sharded-zero3] engine (one teacher-forced prompt
#: each), its teacher-forced decode steps, and the served prompts (the
#: first of PROMPT_LENS) and new tokens of its paged run: each prefill
#: and each step gathers every layer over gloo (a chatglm3-6b pass ~4 s
#: at (2, 1), a qwen2-moe pass ~8 s at (2, 2)).
ZERO3_SLOTS, ZERO3_FORCED, ZERO3_SERVED, ZERO3_NEW = 2, 2, 2, 2
#: The f32 MoE's logits against one device's.
ZERO3_MOE_TOL = 1e-4


def sharded_zero3_phase(counters, ties):
    """``[sharded-zero3]``: the sharded engines under the recipes that
    split the weights over ``data`` too (``default_recipe``'s
    ``decode+zero3`` for the full-width models), on meshes whose ranks
    share the card over gloo, widths uncut: chatglm3-6b (4 of 28 layers,
    bf16) at (2, 1) under ``decode+zero3`` and ``decode`` in one spawn,
    their teacher-forced logits equal bit for bit and each within
    ``LOGIT_TOL`` of one device; qwen2-moe-a2.7b (1 of 24, f32) at
    (2, 2) under ``decode+zero3``, 30 experts a rank, teacher-forced
    within ``ZERO3_MOE_TOL`` of one device and served paged with one
    device's tokens (no routing agreement: each ``data`` rank routes its
    own slots' tokens); on every rank its bytes equal to ``capacity``'s
    under its recipe and its peak printed beside them plus the largest
    layer it gathers; then mixtral-8x22b at (2, 8) under
    ``decode+zero3`` beside (1, 8) under ``decode``, host only. The
    chatglm3-6b spawn runs its [dryrun] tie too (``ties``). Returns the
    launches summed over every rank's runs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.analysis.capacity import serve_preflight
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import default_recipe, get_recipe
    from repro_torch.models import ModelRuntime, init_params

    t_phase = time.perf_counter()
    tag = "[sharded-zero3]"

    def model(name, model_axis):
        full = get_arch(name)
        recipe = default_recipe(full, "decode", model_axis).name
        check(recipe == "decode+zero3", f"{name} at model {model_axis}: "
              f"default_recipe chose {recipe}")
        return dataclasses.replace(full, n_layers=ZERO3_LAYERS[name]), recipe

    def served(cfg):
        rng = np.random.default_rng(1)
        return [dict(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                     .astype(np.int32), max_new_tokens=ZERO3_NEW)
                for i, n in enumerate(PROMPT_LENS[:ZERO3_SERVED])]

    bf16, f32 = ModelRuntime(), ModelRuntime(dtype="float32")
    totals = []
    gc.collect()
    torch.cuda.empty_cache()
    cfg, recipe = model("chatglm3-6b", 1)
    params = init_params(cfg, seed=0, rt=bf16)     # cast leaf by leaf
    expect = {"rmsnorm", "flash_attention", "decode_attention"}
    items = [dict(kind="serve", title=f"chatglm3-6b ({cfg.n_layers} of 28 "
                  f"layers) bf16 {r}", cfg=cfg, params=params,
                  runs=sharded_runs(cfg, bf16, teacher=True, served=[],
                                    layouts=(False,), n_slots=ZERO3_SLOTS,
                                    forced_steps=ZERO3_FORCED,
                                    recipe=r)[:1],
                  expect=expect, logit_tol=LOGIT_TOL)
             for r in (recipe, "decode")]
    items[1]["same_bits_as"] = 0
    items.append(tie_item(ties, "chatglm3-6b zero3", params, cfg))
    totals.append(sharded_spawn((2, 1), items, tag))
    del items, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, recipe = model("qwen2-moe-a2.7b", 2)
    params = init_params(cfg, seed=0, device="cuda")          # f32
    every = sharded_runs(cfg, f32, teacher=True, served=served(cfg),
                         n_slots=ZERO3_SLOTS, forced_steps=ZERO3_FORCED,
                         recipe=recipe)
    totals.append(sharded_spawn((2, 2), [dict(
        kind="serve", title=f"qwen2-moe-a2.7b ({cfg.n_layers} of 24 layers) "
        f"f32 {recipe}", cfg=cfg, params=params,
        runs=[every[0], every[3]],         # teacher-forced, served paged
        expect={"rmsnorm", "flash_attention", "decode_attention",
                "paged_decode_attention", "moe_gemm"},
        logit_tol=ZERO3_MOE_TOL, equal_tokens=True)], tag))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("mixtral-8x22b")
    recipe = default_recipe(cfg, "decode", 8)
    reps = [(mesh, serve_preflight(
        cfg, n_slots=4, max_len=1024, dtype="bfloat16", recipe=r,
        mesh={"data": mesh[0], "model": mesh[1]}))
        for mesh, r in (((2, 8), recipe), ((1, 8), "decode"))]
    for mesh, rep in reps:
        gathered = largest_gather(cfg, get_recipe(rep.recipe),
                                  {"data": mesh[0], "model": mesh[1]}, bf16)
        print(f"{tag} mixtral-8x22b full width at {mesh} under "
              f"{rep.recipe}, 4 slots x 1024, host only: per rank params "
              f"{rep.params_bytes} B + cache {rep.cache_bytes} B, predicted "
              f"peak {rep.peak_bytes} B of {rep.hbm_bytes} B "
              f"({'fits' if rep.fits else 'does not fit'}); largest layer "
              f"gathered over data {gathered} B (not priced by the model)")
    z, d = reps[0][1].params_bytes, reps[1][1].params_bytes
    check(z < d, f"mixtral-8x22b: decode+zero3 at (2, 8) holds {z} B, "
          f"decode at (1, 8) {d} B")
    print(f"{tag} mixtral-8x22b: a rank's parameters under decode+zero3 at "
          f"(2, 8) are {z / d:.6f} of decode's at (1, 8)")
    zero3 = {k: sum(t.get(k, 0) for t in totals) for k in counters}
    print(f"{tag} launches over all meshes {zero3}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return zero3


# ===========================================================================
# [sharded-train]: training on a mesh of ranks that share the card
# ===========================================================================
#: Depths of the full-width models trained on a mesh (widths uncut): the
#: mesh and its one-device reference run one after the other on the card,
#: and a shared-card IS step gathers every layer over gloo (5.6 s a step
#: at 8 layers, 4.1-6.5 s at 6: the embedding's gather and sum do not
#: shrink with depth), so minicpm-2b runs 4 of its 40 layers; the MoE
#: and SSM spawn took 79 s at 2 and 4 layers (a 2.1 GB f32 expert layer
#: gathered a step), so they run 1 and 2.
SHARDED_TRAIN_LAYERS = {"minicpm-2b": 4, "chatglm3-6b": 4,
                        "qwen2-moe-a2.7b": 1, "mamba2-1.3b": 2}
#: The global batch and length of every [sharded-train] step.
SHARDED_TRAIN_B, SHARDED_TRAIN_S = 4, 256
#: Seconds one mesh's spawn may take, its runs included.
SHARDED_TRAIN_TIMEOUT = 600
#: The kernels every rank's train runs must launch, and no other.
SHARDED_TRAIN_KERNELS = ("rmsnorm", "flash_attention")
#: GPipe at the reference test's shapes (tests/test_multidevice.py):
#: layers, stages, microbatches, microbatch rows, width.
GPIPE_SHAPE = (8, 4, 6, 2, 16)


def _gpipe_stage(local_w, h):
    import torch
    for wi in local_w:
        h = torch.tanh(h @ wi)
    return h


def gpipe_rank(mesh, w, x):
    """GPipe on a (stage, data) mesh of (4, 1) over this process group:
    this rank's stage block of ``w``, the outputs on every rank and the
    gradient of ``sum(out ** 2)`` in the block."""
    import torch
    from repro_torch.dist.pipeline import pipeline_apply, stage_split
    from repro_torch.launch.mesh import make_mesh
    n_stages = GPIPE_SHAPE[1]
    pipe = make_mesh((n_stages, 1), ("stage", "data"), devices=str(mesh.device))
    s = pipe.coords["stage"]
    block = stage_split(w.to(pipe.device), n_stages)[s:s + 1]
    block = block.clone().requires_grad_()
    t0 = time.perf_counter()
    out = pipeline_apply(_gpipe_stage, pipe, n_stages)(block,
                                                       x.to(pipe.device))
    (g,) = torch.autograd.grad((out ** 2).sum(), [block])
    torch.cuda.synchronize()
    return dict(label="gpipe", rank=mesh.rank, stage=s, out=out.detach().cpu(),
                grad=g[0].cpu(), ms=(time.perf_counter() - t0) * 1e3)


def sharded_train_rank(mesh, runs, gpipe=None, ties=()):
    """One rank of a [sharded-train] mesh (``run_mesh`` spawns it; the
    parent built the kernel library, this process loads it): each run
    through ``train.sharded.mesh_train`` on this rank's blocks of the
    parent's tensors (read over CUDA IPC), every launch count set to 0
    before it and read after, the rank's peak since it began; then,
    with ``gpipe`` (its weights and input), GPipe over the same ranks;
    then each of ``ties`` (``(params, cfg, runs)``), a [dryrun] tie."""
    import torch
    from repro_torch.train.sharded import mesh_train
    counters = kernel_counters()
    take_cublas_workspace(mesh.device)
    out = []
    for run in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        rec = mesh_train(mesh, [run])[0]
        torch.cuda.synchronize()
        rec.update(label=run["label"],
                   peak=torch.cuda.max_memory_allocated() - base,
                   launches={k: c.launches for k, c in counters.items()})
        out.append(rec)
        gc.collect()
        torch.cuda.empty_cache()
    if gpipe is not None:
        out.append(gpipe_rank(mesh, *gpipe))
    for tie in ties:
        out.append(tie_rank(mesh, *tie))
    return out


def sharded_train_batches(cfg, n):
    """``n`` global lcg batches of ``SyntheticLMData`` (B
    ``SHARDED_TRAIN_B``, S ``SHARDED_TRAIN_S``), on the host."""
    from repro_torch.data import SyntheticLMData
    data = SyntheticLMData(SHARDED_TRAIN_S, SHARDED_TRAIN_B, cfg.vocab_size,
                           seed=11)
    return [data.batch_at(i) for i in range(n)]


def sharded_train_tc(cfg):
    from repro_torch.train import AdamWConfig, TrainConfig
    return TrainConfig(opt=AdamWConfig(
        peak_lr=1e-3, warmup_steps=2, total_steps=10,
        schedule="wsd" if cfg.lr_schedule == "wsd" else "cosine"))


def one_device_train(cfg, params, batches, dtype, grads=False):
    """The one-device reference of a mesh run: its train step (cuda
    policy, remat none) on a copy of ``params`` over ``batches``; with
    ``grads`` step 0's gradients first. Its launches count on no path."""
    import torch
    from repro_torch.models import ModelRuntime
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.tree import tree_map
    rt = ModelRuntime(dtype=dtype, remat="none")
    step = make_train_step(cfg, rt, sharded_train_tc(cfg))
    dev = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
           for b in batches]
    out = dict(loss=[], grad_norm=[], step_ms=[], grads=None)
    if grads:
        out["grads"] = step.grads(params, dev[0])[2]
    state = init_state(tree_map(torch.clone, params))
    for b in dev:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def held_to_one_device(title, recs, ref, grads=True):
    """Every rank's losses and gradient norms equal rank 0's; rank 0's
    within ``TRAIN_LOSS_RTOL`` / ``TRAIN_GRAD_RTOL`` of one device's per
    step, step 0's gradient blocks of every rank within
    ``TRAIN_GRAD_RTOL`` of one device's, each leaf held to its own
    largest gradient. Returns the line's numbers and the worst leaf."""
    r0 = recs[0]
    for r in recs[1:]:
        check(r["loss"] == r0["loss"] and r["grad_norm"] == r0["grad_norm"],
              f"{title}: rank {r['rank']} reported other scalars than "
              f"rank 0")
    dl = max(abs(a - b) / abs(b) for a, b in zip(r0["loss"], ref["loss"]))
    dn = max(abs(a - b) / abs(b)
             for a, b in zip(r0["grad_norm"], ref["grad_norm"]))
    check(dl < TRAIN_LOSS_RTOL, f"{title}: loss {r0['loss']} vs one device "
          f"{ref['loss']}, rel {dl:.3e}")
    check(dn < TRAIN_GRAD_RTOL, f"{title}: grad norm {r0['grad_norm']} vs "
          f"one device {ref['grad_norm']}, rel {dn:.3e}")
    out = dict(loss_rel=dl, norm_rel=dn)
    if grads:
        worst = max((r["grad_dev"] for r in recs), key=lambda d: d["rel"])
        check(worst["rel"] < TRAIN_GRAD_RTOL, f"{title}: step-0 gradient "
              f"of {worst['leaf']} {worst['rel']:.3e} of that leaf's "
              f"largest from one device")
        out["grad_rel"], out["grad_leaf"] = worst["rel"], worst["leaf"]
    return out


def sharded_train_mesh(title, mesh, runs, refs, gpipe=None, ties=()):
    """One mesh of [sharded-train]: its runs on every rank (GPipe after
    them with ``gpipe``), each held to its one-device reference
    (``refs[i]``: None for no comparison), every rank's state bytes to
    the sharded capacity model's, ``SHARDED_TRAIN_KERNELS`` launched on
    every rank and no other kernel; then each of ``ties`` ([dryrun] tie
    items) held by :func:`tie_check`. Returns (the launches summed over
    ranks and runs, the ties' included, every rank's records but the
    ties')."""
    import torch
    from repro_torch.analysis.capacity import capacity
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import run_mesh
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    ranks = run_mesh(sharded_train_rank, mesh, runs, gpipe,
                     [(t["params"], t["cfg"], t["runs"]) for t in ties],
                     timeout=SHARDED_TRAIN_TIMEOUT)
    cut = len(ranks[0]) - len(ties)
    tied = [r[cut:] for r in ranks]
    ranks = [r[:cut] for r in ranks]
    sizes = {"data": mesh[0], "model": mesh[1]}
    print(f"[sharded-train] {title}: mesh {mesh[0]}x{mesh[1]} (data, model), "
          f"{len(ranks)} ranks on {torch.cuda.device_count()} card(s) over "
          f"{ranks[0][0]['backend']}; spawn and runs "
          f"{time.perf_counter() - t0:.1f} s; the parent held "
          f"{held / 2**30:.2f} GiB")
    total = {}
    for i, run in enumerate(runs):
        recs = [r[i] for r in ranks]
        cfg, r0 = run["cfg"], recs[0]
        rep = capacity(cfg, ShapeConfig("train", SHARDED_TRAIN_S,
                                        SHARDED_TRAIN_B, "train"),
                       mesh=sizes, recipe=run["recipe"])
        want = rep.params_bytes * 3 + 4
        for r in recs:
            check(r["state_bytes"] == want, f"{title} {run['label']} rank "
                  f"{r['rank']}: state {r['state_bytes']} B, predicted "
                  f"{want} B")
            launched = {k for k, n in r["launches"].items() if n}
            kernels = run.get("kernels", SHARDED_TRAIN_KERNELS)
            check(launched == set(kernels),
                  f"{title} {run['label']} rank {r['rank']}: launched "
                  f"{sorted(launched)}, not {kernels}")
            check(all(math.isfinite(x) for x in r["loss"]),
                  f"{title} {run['label']}: non-finite loss {r['loss']}")
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
        line = (f"[sharded-train] {title} {run['label']} ({cfg.n_layers} "
                f"layers, recipe {run['recipe']}): loss by step "
                f"{' '.join(f'{x:.6f}' for x in r0['loss'])}, grad norm "
                f"{' '.join(f'{x:.6f}' for x in r0['grad_norm'])}")
        ref = refs[i]
        if ref is not None and run.get("bf16_step0"):
            d0 = abs(r0["loss"][0] - ref["loss"][0])
            check(d0 <= TRAIN_BF16_LOSS_TOL, f"{title} {run['label']}: "
                  f"step-0 loss {r0['loss'][0]} vs one device "
                  f"{ref['loss'][0]}")
            line += (f"; step 0 vs one device {ref['loss'][0]:.6f} (|d| "
                     f"{d0:.6f}, tol {TRAIN_BF16_LOSS_TOL})")
        elif ref is not None:
            got = held_to_one_device(f"{title} {run['label']}", recs, ref,
                                     grads="grad_dev" in r0)
            line += (f"; one device loss "
                     f"{' '.join(f'{x:.6f}' for x in ref['loss'])}: |dloss|"
                     f"/|loss| {got['loss_rel']:.3e} (tol "
                     f"{TRAIN_LOSS_RTOL:g}), grad norm rel "
                     f"{got['norm_rel']:.3e}")
            if "grad_rel" in got:
                line += (f", step-0 gradients max|dg|/max|g| per leaf "
                         f"over every rank's blocks, worst "
                         f"{got['grad_rel']:.3e} at {got['grad_leaf']} "
                         f"(tol {TRAIN_GRAD_RTOL:g})")
        if "restore_s" in r0:
            line += (f"; restored in "
                     f"{max(r['restore_s'] for r in recs):.1f} s")
        if "save_s" in r0:
            line += (f"; saved from the mesh in "
                     f"{max(r['save_s'] for r in recs):.1f} s")
        mesh_ms = statistics.median(r0["step_ms"])
        line += (f"; step ms {' '.join(f'{t:.1f}' for t in r0['step_ms'])} "
                 f"(median {mesh_ms:.1f}")
        if ref is not None:
            line += f"; one device {statistics.median(ref['step_ms']):.1f}"
        line += (f"); per rank state {want} B = predicted (params "
                 f"{rep.params_bytes} x 3 + 4), peaks "
                 f"{[r['peak'] for r in recs]} B; launches per rank "
                 f"{[{k: v for k, v in r['launches'].items() if v} for r in recs]}")
        print(line)
    for j, tie in enumerate(ties):
        got = tie_check(tie, tie["mesh"], [r[j] for r in tied],
                        dry_traces(None, None, tie["runs"]))
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
    return total, ranks


def sharded_train_families(f32):
    """[sharded-train]'s MoE and SSM runs, one (2, 2) spawn, f32,
    one step each held to one device (loss, norm, step 0's gradient
    blocks leaf by leaf; minicpm-2b's IS run takes two steps):
    full-width qwen2-moe-a2.7b (1 layer) under IS on the capacity path
    (its capacity, slot order and aux loss global over ``data``; 30
    experts of a layer a rank between gathers) and mamba2-1.3b (2
    layers) under its launcher recipe IS_seq (32 SSD heads a rank, B/C
    whole). Returns the launches over ranks and
    runs."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    runs, refs = [], []
    for name, recipe, kernels in (
            ("qwen2-moe-a2.7b", "IS", ("rmsnorm", "flash_attention")),
            ("mamba2-1.3b", "IS_seq", ("rmsnorm", "ssd_scan"))):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_arch(name),
                                  n_layers=SHARDED_TRAIN_LAYERS[name])
        params = init_params(cfg, seed=0, device="cuda")          # f32
        batches = sharded_train_batches(cfg, 1)
        t0 = time.perf_counter()
        refs.append(one_device_train(cfg, params, batches, "float32",
                                     grads=True))
        print(f"[sharded-train] {name} one device (f32 gradients + 1 "
              f"step): {time.perf_counter() - t0:.1f} s")
        runs.append(dict(cfg=cfg, params=params, tc=sharded_train_tc(cfg),
                         recipe=recipe, label=f"{name} f32", rt=f32,
                         batches=batches, ref_grads=refs[-1]["grads"],
                         kernels=kernels))
    got, _ = sharded_train_mesh("full width, (2, 2)", (2, 2), runs, refs)
    del runs, refs
    gc.collect()
    torch.cuda.empty_cache()
    return got


def launcher_mesh_runs():
    """The train launcher in-process on smoke minicpm-2b: ``--mesh 2x2
    --recipe IS --steps 10`` with a checkpoint directory, then a resume
    on ``--mesh 1x2 --recipe WS``; its printed lines echoed."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.launch import train as launcher
    d = tempfile.mkdtemp(prefix="sharded_train_launch-")
    try:
        base = ["--arch", "minicpm-2b", "--smoke", "--steps", "10",
                "--ckpt-dir", d]
        outs = []
        for extra in (["--mesh", "2x2", "--recipe", "IS"],
                      ["--mesh", "1x2", "--recipe", "WS"]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                got = launcher.main(base + extra)
            dt = time.perf_counter() - t0
            for ln in buf.getvalue().splitlines():
                print(f"[sharded-train] launcher {' '.join(extra)}: {ln}")
            print(f"[sharded-train] launcher {' '.join(extra)}: {dt:.1f} s")
            check(len(got["losses"]) == 10 and all(
                math.isfinite(x) for x in got["losses"]),
                f"launcher {extra}: losses {got['losses']}")
            outs.append((buf.getvalue(), got))
        check(outs[0][1]["restored"] is None
              and outs[1][1]["restored"] == 10
              and "restoring from step 10" in outs[1][0],
              "launcher: the resume on 1x2 did not restore step 10")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def sharded_train_phase(counters, ties):
    """``[sharded-train]``: the sharded train step on meshes whose ranks
    share the card over gloo. Full-width minicpm-2b (4 layers) under IS
    at (2, 2): two f32 AdamW steps against one device's (losses, gradient
    norms, step 0's gradients) and a bf16 step (against one device's),
    its state saved from the mesh; full-width chatglm3-6b (4 layers)
    under WS at (1, 4) (its K/V heads shared by rank pairs, its
    vocabulary split) against one device and GPipe on a (stage, data)
    mesh of (4, 1) against the sequential form in one spawn; the
    minicpm-2b checkpoint restored onto one device (bits equal to the
    files); the train launcher's ``--mesh`` run and its resume on
    another mesh. Returns the launches summed over every rank's train
    runs."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.ckpt import restore
    from repro_torch.ckpt.checkpoint import _fname, _keystr, read_leaf
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import pick_backend
    from repro_torch.models import ModelRuntime, init_params
    from repro_torch.tree import tree_items

    t_phase = time.perf_counter()
    print(f"[sharded-train] backend rule: {torch.cuda.device_count()} "
          f"card(s), ranks 4 -> {pick_backend(4)} (nccl only when every "
          f"rank has a card); the parent holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; {smi_line()}")
    f32 = ModelRuntime(dtype="float32", remat="none")
    bf16 = ModelRuntime(dtype="bfloat16", remat="none")
    totals = []
    tmp = tempfile.mkdtemp(prefix="sharded_train-")
    try:
        # --- minicpm-2b at (2, 2) IS: f32, bf16, the checkpoint ----------
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_arch("minicpm-2b"),
                                  n_layers=SHARDED_TRAIN_LAYERS["minicpm-2b"])
        params = init_params(cfg, seed=0, device="cuda")          # f32
        batches = sharded_train_batches(cfg, 2)
        tc = sharded_train_tc(cfg)
        t0 = time.perf_counter()
        ref32 = one_device_train(cfg, params, batches[:2], "float32",
                                 grads=True)
        ref16 = one_device_train(cfg, params, batches[:1], "bfloat16")
        print(f"[sharded-train] minicpm-2b one device (f32 gradients + 2 "
              f"steps, bf16 1 step): {time.perf_counter() - t0:.1f} s")
        common = dict(cfg=cfg, params=params, tc=tc, recipe="IS")
        runs = [dict(common, label="minicpm-2b f32", rt=f32,
                     batches=batches[:2], ref_grads=ref32["grads"],
                     save=(tmp, 2)),
                dict(common, label="minicpm-2b bf16", rt=bf16,
                     batches=batches[:1], bf16_step0=True)]
        got, _ = sharded_train_mesh(
            "full width, (2, 2)", (2, 2), runs, [ref32, ref16],
            ties=[tie_item(ties, name, params, cfg) for name in (
                "minicpm-2b train", "minicpm-2b pod train")])
        totals.append(got)
        del ref32, runs, common
        gc.collect()
        # the checkpoint onto one device: the files' bits
        like = {"params": params, "opt": {"mu": params, "nu": params,
                                          "step": torch.zeros(
                                              (), dtype=torch.int32,
                                              device="cuda")}}
        state = restore(tmp, 2, like)
        with open(Path(tmp) / "step_00000002" / "manifest.json") as f:
            manifest = json.load(f)["leaves"]
        for keys, leaf in tree_items(state):
            name = _fname(_keystr(keys))
            want = read_leaf(str(Path(tmp) / "step_00000002" /
                                 f"{name}.npy"), manifest[name]["dtype"])
            check(torch.equal(leaf.cpu(), want), f"one-device restore: "
                  f"{keys} differs from the file")
        del state, like, params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[sharded-train] minicpm-2b checkpoint (saved from (2, 2) "
              f"IS at step 2) restored onto one device: every leaf == its "
              f"file, bit for bit")

        # --- chatglm3-6b at (1, 4) WS, GPipe ------------------------------
        gcfg = dataclasses.replace(
            get_arch("chatglm3-6b"),
            n_layers=SHARDED_TRAIN_LAYERS["chatglm3-6b"])
        gparams = init_params(gcfg, seed=0, device="cuda")
        gbatches = sharded_train_batches(gcfg, 2)
        t0 = time.perf_counter()
        gref = one_device_train(gcfg, gparams, gbatches, "float32",
                                grads=True)
        print(f"[sharded-train] chatglm3-6b one device (f32 gradients + 2 "
              f"steps): {time.perf_counter() - t0:.1f} s")
        n_layers, _, n_micro, mb, d = GPIPE_SHAPE
        gen = torch.Generator(device="cuda").manual_seed(0)
        w = torch.randn(n_layers, d, d, device="cuda", generator=gen) * 0.2
        x = torch.randn(n_micro, mb, d, device="cuda", generator=gen)
        runs = [dict(cfg=gcfg, params=gparams, tc=sharded_train_tc(gcfg),
                     recipe="WS", label="chatglm3-6b f32", rt=f32,
                     batches=gbatches, ref_grads=gref["grads"])]
        got, ranks = sharded_train_mesh(
            "full width, (1, 4)", (1, 4), runs, [gref], gpipe=(w, x),
            ties=[tie_item(ties, "chatglm3-6b pp", gparams, gcfg)])
        totals.append(got)
        del gref, gparams, runs
        # GPipe against the sequential form under autograd
        wl = w.clone().requires_grad_()
        h = x
        for wi in wl:
            h = torch.tanh(h @ wi)
        (g_seq,) = torch.autograd.grad((h ** 2).sum(), [wl])
        h = h.detach()
        pipes = [r[-1] for r in ranks]
        per = n_layers // GPIPE_SHAPE[1]
        g_pipe = torch.zeros_like(g_seq)
        dout = 0.0
        for r in pipes:
            dout = max(dout, float((r["out"].cuda() - h).abs().max()))
            check(torch.allclose(r["out"].cuda(), h, atol=1e-5, rtol=1e-5),
                  f"gpipe: rank {r['rank']}'s outputs differ from the "
                  f"sequential form by {dout:.3e}")
            g_pipe[r["stage"] * per:(r["stage"] + 1) * per] = r["grad"]
        dg = float((g_pipe - g_seq).abs().max() / g_seq.abs().max())
        check(dg < TRAIN_GRAD_RTOL, f"gpipe: gradients {dg:.3e} of the "
              f"largest from the sequential form's")
        print(f"[sharded-train] gpipe (stage, data) (4, 1), {n_layers} tanh "
              f"layers of {d}, {n_micro} microbatches of {mb}, f32: outputs "
              f"max|pipe - sequential| {dout:.3e} (atol/rtol 1e-5), "
              f"gradients max|dg|/max|g| {dg:.3e} (tol {TRAIN_GRAD_RTOL:g}); "
              f"{max(r['ms'] for r in pipes):.1f} ms forward and backward")
        del w, x, wl, h, g_seq, g_pipe
        gc.collect()
        torch.cuda.empty_cache()

    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    totals.append(sharded_train_families(f32))
    launcher_mesh_runs()
    trained = {k: sum(t.get(k, 0) for t in totals) for k in counters}
    print(f"[sharded-train] launches over every rank's train runs "
          f"{ {k: v for k, v in trained.items() if v} }; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {smi_line()}")
    return trained


def capacity_phase():
    """``[capacity]``: every run's prediction against its measured peak,
    per kind, held to ``PARITY_REL_TOL``, and its argument bytes to at
    most the measured peak."""
    from repro_torch.analysis.capacity import CALIBRATION, PARITY_REL_TOL
    for kind in ("decode", "prefill", "train"):
        recs = [r for r in CAPACITY if r["kind"] == kind]
        if not recs:
            continue
        worst = max(recs, key=lambda r: r["rel_err"])
        print(f"[capacity] {kind}: {len(recs)} runs; worst |measured - "
              f"predicted| / measured {worst['rel_err']:.4f} ({worst['arch']}"
              f" {worst['engine']} {worst['kv_dtype']}), bar "
              f"{PARITY_REL_TOL}; coefficients {CALIBRATION[kind]}")
        for r in recs:
            check(r["argument_bytes"] <= r["measured_bytes"],
                  f"capacity {r['arch']} {r['engine']}: argument bytes "
                  f"{r['argument_bytes']} over the measured peak "
                  f"{r['measured_bytes']}")
            check(r["rel_err"] <= PARITY_REL_TOL,
                  f"capacity {kind} {r['arch']} {r['engine']} "
                  f"{r['kv_dtype']}: predicted {r['peak_bytes']} B, "
                  f"measured {r['measured_bytes']} B, rel err "
                  f"{r['rel_err']:.4f} > {PARITY_REL_TOL}")
    # runs the fit has not seen: a miss is a finding about the model's
    # reach, reported against the same bar (ROADMAP.md Queue 3), not a
    # fault of the run
    kinds = [r["kind"] for r in HELD_OUT]
    check(kinds.count("prefill") >= 3 and kinds.count("train") >= 1,
          f"capacity: held-out runs {kinds}")
    misses = 0
    for r in HELD_OUT:
        within = r["rel_err"] <= PARITY_REL_TOL
        misses += not within
        print(f"[capacity] held-out {r['kind']} {r['arch']} {r['engine']}:"
              f" predicted "
              f"{r['peak_bytes']} B, measured {r['measured_bytes']} B, "
              f"|measured - predicted| / measured {r['rel_err']:.4f} "
              f"{'within' if within else 'MISSES'} the bar "
              f"{PARITY_REL_TOL} (no refit)")
        check(r["argument_bytes"] <= r["measured_bytes"],
              f"capacity held-out {r['arch']} {r['engine']}: argument "
              f"bytes {r['argument_bytes']} over the measured peak")
    print(f"[capacity] held-out: {len(HELD_OUT)} runs ({kinds.count('prefill')}"
          f" prefill, {kinds.count('train')} train), {misses} past "
          f"{PARITY_REL_TOL}; coefficients prefill {CALIBRATION['prefill']}"
          f", train {CALIBRATION['train']}")


# ===========================================================================
# Phase 5: training
# ===========================================================================
#: Batch and length of the train phase: B 2 for the f32 gradient checks,
#: B 4 for the bf16 AdamW steps, S 512 for both.
TRAIN_CHECK_B, TRAIN_B, TRAIN_S = 2, 4, 512
#: f32, cuda vs torch policy, TF32 off: the loss within 1e-5 of itself,
#: and the largest gradient difference over all leaves within 1e-3 of
#: the largest gradient (the reference's bar for its kernels under
#: autograd, tests/test_kernel_dispatch.py).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-3
#: bf16: step 0's loss under the cuda policy against the torch policy's
#: on the same batch (both round every activation to bf16).
TRAIN_BF16_LOSS_TOL = 0.02
#: qwen2-moe trains at full width and 2 layers: 24 layers of f32 weights
#: and AdamW state need ~229 GB, 2 layers ~28 GB.
MOE_TRAIN_LAYERS = 2
#: zamba2-2.7b's bf16 steps run at B 2: its f32 masters, moments and
#: gradients take 2.5 B x 16 bytes = 40 GB and its bf16 copies 5 GB, and
#: its activations at B 4 (54 Mamba-2 layers of d_inner 5120, scaled from
#: mamba2-1.3b's ~24 GB) would take ~34 GB more.
HYBRID_TRAIN_B = 2
#: Kernels no training path runs (the decode kernels, the int8 matmul).
TRAIN_ABSENT = ("decode_attention", "paged_decode_attention",
                "quant_decode_attention", "quant_paged_decode_attention",
                "quant_matmul")


def train_run(label, counters, expect, fn):
    """``fn()`` with every launch count set to 0 before it; afterwards the
    kernels in ``expect`` must have launched and every other kernel not.
    Returns (fn's result, the launches)."""
    import torch
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    for name, n in launches.items():
        if name in expect:
            check(n > 0, f"{label}: kernel {name} was not launched")
        else:
            check(n == 0, f"{label}: kernel {name} ran {n} times")
    return out, launches


def train_batch(cfg, b, seed):
    """``SyntheticLMData``'s lcg batch 0 (B ``b``, S ``TRAIN_S``) on the
    card."""
    import torch
    from repro_torch.data import SyntheticLMData
    data = SyntheticLMData(TRAIN_S, b, cfg.vocab_size, seed=seed)
    return {k: torch.from_numpy(v).cuda() for k, v in
            data.batch_at(0).items()}


def grad_check(label, cfg, params, counters, expect, **rt_kw):
    """One f32 loss and gradient at B ``TRAIN_CHECK_B``, S ``TRAIN_S``,
    remat none, under the cuda and the torch policy: the cuda pass runs
    ``expect``'s kernels forward (the plain versions' autograd as their
    backward), the torch pass none. Returns the cuda pass's launches."""
    import torch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_items

    batch = train_batch(cfg, TRAIN_CHECK_B, seed=5)
    res = {}
    for pol in ("cuda", "torch"):
        rt = ModelRuntime(dtype="float32", remat="none",
                          kernels=getattr(KernelPolicy, pol)(), **rt_kw)
        res[pol], launches = train_run(
            f"{label} f32 gradients, {pol} policy", counters,
            expect if pol == "cuda" else set(),
            lambda: value_and_grad(cfg, rt, params, batch))
        if pol == "cuda":
            cuda_launches = launches
    (lc, _, gc_), (lt, _, gt) = res["cuda"], res["torch"]
    loss_rel = float((lc - lt).abs() / lt.abs())
    dmax = gmax = 0.0
    for path_c, path_t in zip(tree_items(gc_), tree_items(gt)):
        check(path_c[0] == path_t[0], f"{label}: gradient trees differ")
        a, b = path_c[1], path_t[1]
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite "
              f"gradient {path_c[0]}")
        dmax = max(dmax, float((a - b).abs().max()))
        gmax = max(gmax, float(b.abs().max()))
    print(f"[train] {label} f32 B{TRAIN_CHECK_B} S{TRAIN_S}, cuda vs torch "
          f"policy: loss {float(lc):.6f} vs {float(lt):.6f}, |dloss|/|loss| "
          f"{loss_rel:.3e} (tol {TRAIN_LOSS_RTOL:g}); gradients max|dg| / "
          f"max|g| {dmax / gmax:.3e} over {len(list(tree_items(gt)))} leaves "
          f"(max|g| {gmax:.4e}, tol {TRAIN_GRAD_RTOL:g}); cuda launches "
          f"{ {k: v for k, v in cuda_launches.items() if v} }")
    check(loss_rel < TRAIN_LOSS_RTOL, f"{label}: f32 loss differs by "
          f"{loss_rel:.3e}")
    check(dmax / gmax < TRAIN_GRAD_RTOL, f"{label}: f32 gradients differ "
          f"by {dmax / gmax:.3e} of the largest")
    return cuda_launches


def train_steps(label, cfg, params, counters, expect, steps, batch=TRAIN_B,
                seq=TRAIN_S, held_out=False, **rt_kw):
    """``steps`` bf16 AdamW steps of ``make_train_step`` on the f32
    masters (the launcher's runtime: remat none, the config's schedule),
    B ``batch``, S ``seq``, on ``SyntheticLMData``'s lcg batches:
    every loss finite, step 0's within ``TRAIN_BF16_LOSS_TOL`` of the
    torch policy's on the same batch. Prints the losses, the median step
    time over steps 1.. (host clock, synchronised), tokens/s, MFU against
    the H100's bf16 dense peak, the peak memory and the launches; the
    peak against the capacity model in a ``[capacity]`` line, or with
    ``held_out`` a ``[capacity] held-out train`` line the fit does not
    read. Returns (the launches, the state, the step function, a batch,
    the median step ms, the peak GiB)."""
    import dataclasses
    import torch
    from repro_torch.analysis.capacity import capacity
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, loss_fn
    from repro_torch.train import AdamWConfig, TrainConfig
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.tree import tree_leaves

    rt = ModelRuntime(dtype="bfloat16", remat="none", **rt_kw)
    data = SyntheticLMData(seq, batch, cfg.vocab_size, seed=9)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.batch_at(i).items()} for i in range(steps)]
    with torch.no_grad():
        ref_loss = float(loss_fn(params, cfg, batches[0], dataclasses.replace(
            rt, kernels=KernelPolicy.torch()))[0])
    tc = TrainConfig(opt=AdamWConfig(
        peak_lr=3e-3, warmup_steps=5, total_steps=steps,
        schedule="wsd" if cfg.lr_schedule == "wsd" else "cosine"))
    step_fn = make_train_step(cfg, rt, tc)
    state = init_state(params)
    other = peak_start(tree_bytes(state))

    def run():
        losses, times = [], []
        st = state
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step_fn(st, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, times

    (losses, times), launches = train_run(f"{label} bf16 steps", counters,
                                          expect, run)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    engine = f"train B{batch} S{seq} {cfg.n_layers} layers"
    rep = capacity(cfg, ShapeConfig("train", seq, batch, "train"))
    if held_out:
        measured = torch.cuda.max_memory_allocated() - other
        rec = dict(arch=cfg.name, kind="train", engine=engine, kv_dtype="-",
                   features=rep.features, argument_bytes=rep.argument_bytes,
                   peak_bytes=rep.peak_bytes, measured_bytes=measured,
                   other_bytes=other,
                   rel_err=abs(measured - rep.peak_bytes) / measured)
        print("[capacity] held-out train " + json.dumps(rec))
        HELD_OUT.append(rec)
    else:
        capacity_record(cfg.name, "train", engine, None, rep, other)
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite "
          f"loss {losses}")
    d0 = abs(losses[0] - ref_loss)
    n_params = sum(t.numel() for t in tree_leaves(params))
    step_ms = statistics.median(times[1:])
    tok_s = batch * seq / step_ms * 1e3
    mfu = 6 * n_params * batch * seq / (step_ms / 1e3) \
        / PEAK_OPS["bf16_tensor"]
    print(f"[train] {label} bf16 AdamW, B{batch} S{seq}, {tc.opt.schedule}"
          f": loss by step {' '.join(f'{x:.4f}' for x in losses)}; step 0 "
          f"vs torch policy {ref_loss:.4f} (|d| {d0:.4f}, tol "
          f"{TRAIN_BF16_LOSS_TOL}); step ms {' '.join(f'{t:.1f}' for t in times)}"
          f", median over steps 1-{steps - 1} {step_ms:.2f} ms, "
          f"{tok_s:.1f} tok/s, MFU {mfu:.4f} (6 x {n_params / 1e9:.3f} B "
          f"params x tokens / step / 989 TFLOP/s); peak {peak:.2f} GiB; "
          f"launches { {k: v for k, v in launches.items() if v} }")
    check(d0 <= TRAIN_BF16_LOSS_TOL, f"{label}: bf16 step-0 loss "
          f"{losses[0]} vs torch policy {ref_loss}")
    return launches, state, step_fn, batches[0], step_ms, peak


def train_phase(counters):
    """Full-width training on the card: minicpm-2b's f32 gradient check
    and five bf16 AdamW steps with a profile of one, then qwen2-moe at 2
    layers (dropless: the sort-once grouped GEMMs under autograd), mamba2
    and zamba2 (its steps at B ``HYBRID_TRAIN_B``), each a gradient check
    and two steps. Returns the launches of every cuda-policy run, summed,
    and per model the measurements ``[explore]`` reads: its config, bf16
    batch, median step ms, peak GiB and (minicpm-2b) the device-busy ms
    of the profiled step."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    totals, runs = [], []
    for name, layers, expect, steps, b, rt_kw in (
            ("minicpm-2b", None, {"rmsnorm", "flash_attention"}, 5, TRAIN_B,
             {}),
            ("qwen2-moe-a2.7b", MOE_TRAIN_LAYERS,
             {"rmsnorm", "flash_attention", "moe_gemm"}, 2, TRAIN_B,
             dict(moe_dropless=True)),
            ("mamba2-1.3b", None, {"rmsnorm", "ssd_scan"}, 2, TRAIN_B, {}),
            ("zamba2-2.7b", None, {"rmsnorm", "flash_attention", "ssd_scan"},
             2, HYBRID_TRAIN_B, {})):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_arch(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda")        # f32
        torch.cuda.synchronize()
        label = f"{name} ({cfg.n_layers} layers)"
        print(f"[train] {label} full width: "
              f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B "
              f"params, f32 masters, seeded init "
              f"{time.perf_counter() - t0:.1f} s")
        totals.append(grad_check(label, cfg, params, counters, expect,
                                 **rt_kw))
        gc.collect()
        torch.cuda.empty_cache()
        launches, state, step_fn, batch, step_ms, peak = train_steps(
            label, cfg, params, counters, expect, steps, batch=b, **rt_kw)
        totals.append(launches)
        run = dict(name=name, cfg=cfg, batch=b, wall_ms=step_ms,
                   peak_gib=peak, device_ms=None)
        if name == "minicpm-2b":          # profile one step of the dense model
            holder = [state]

            def one_step():
                holder[0], _ = step_fn(holder[0], batch)

            run["device_ms"] = device_profile(
                f"{label} bf16 train step B{TRAIN_B} S{TRAIN_S}", one_step,
                steps=1, focus=("flash_fwd", "rmsnorm", "nvjet",
                                "elementwise", "reduce_kernel"))["device_ms"]
            del holder, state, step_fn
            gc.collect()
            torch.cuda.empty_cache()
            # a batch and length CALIBRATION was not fitted on
            got = train_steps(f"{label} held out", cfg, params, counters,
                              expect, 2, batch=HELD_OUT_TRAIN[0],
                              seq=HELD_OUT_TRAIN[1], held_out=True)
            totals.append(got[0])
            state, step_fn = got[1], got[2]
            del got
        runs.append(run)
        del params, state, step_fn, batch
    train = {name: sum(t[name] for t in totals) for name in counters}
    for name in ("rmsnorm", "flash_attention", "moe_gemm", "ssd_scan"):
        check(train[name] > 0, f"train path: {name} never launched")
    print(f"[train] launches over all training runs: {train}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return train, runs


# ===========================================================================
# Phase 6: the one-card model against the card; the paper's flow
# ===========================================================================
#: The one-card model's verdicts are exact to 1e-12 against an
#: exhaustive pass (tests/test_torch_gpu_model.py holds them against the
#: reference's TPU model at one chip).
DSE_RTOL = 1e-12
#: Paradigm 3 contains paradigms 1 and 2 as corner points; its seeded
#: search must reach this share of the better one (the reference's bar,
#: tests/test_dse.py).
PARADIGM3_SHARE = 0.99


def explore_phase(served, runs, int8_devs):
    """No timed run: the one-card analytic model (``gpu_model``) at the
    shapes phases 3-5 ran, beside what they measured; its feasibility
    verdicts (every configuration run fits one card, mixtral-8x22b's
    prefill and 24-layer qwen2-moe training do not); ``explore_gpu`` at
    train_4k against an exhaustive pass over its 14 points; the paper's
    paradigms 1-3 on vgg16 at KU115; the DSE's int8 accuracy proxy
    beside the measured bf16-vs-int8 KV logit deviations."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.analytical import (INT8_LOGIT_DEV_PROXY,
                                             DesignPoint, GPUModel, GPUPlan,
                                             hbm_footprint)
    from repro_torch.core.analytical.gpu_model import analyze
    from repro_torch.core.dse import (benchmark_paradigm, explore_fpga,
                                      explore_gpu)
    from repro_torch.core.hardware import KU115
    from repro_torch.core.workload import cnn_workload
    from repro_torch.models.model import cache_spec

    t0 = time.perf_counter()
    shapes = served_shapes()
    infer, train = GPUPlan(), GPUPlan(microbatches=1, remat="none")

    def line(label, phase, ana, device_ms, wall_ms):
        pred = ana.step_s * 1e3
        dev = "n/a" if device_ms is None else f"{device_ms:.3f}"
        ratio = "n/a" if device_ms is None else f"{device_ms / pred:.2f}x"
        print(f"[explore] {label} {phase} predicted {pred:.3f} ms "
              f"({ana.dominant[:-2]}) device {dev} ms wall {wall_ms:.2f} ms "
              f"device/predicted {ratio} wall/predicted "
              f"{wall_ms / pred:.2f}x")

    for name, measured in served.items():
        cfg = get_arch(name)
        for phase, shape in shapes.items():
            foot = hbm_footprint(cfg, shape, infer)
            total = foot["total"]
            if cfg.family == "hybrid":
                # hbm_footprint prices K/V only for dense, moe and vlm
                # (the reference's gap, ROADMAP.md Queue 3): add the
                # attention groups' cache as the port lays it out
                spec = cache_spec(cfg, shape.global_batch, shape.seq_len)
                kv = sum(math.prod(spec[k][0]) * spec[k][1].itemsize
                         for k in ("k", "v"))
                total += kv
                print(f"[explore] {name} {phase}: hbm_footprint prices no "
                      f"K/V for the hybrid family; its {spec['k'][0][0]} "
                      f"attention groups' bf16 K/V add {kv / 1e9:.3f} GB, "
                      f"counted in this fit check ({total / 1e9:.2f} GB)")
            check(total <= H100_SXM.hbm_bytes, f"{name} {phase} predicted "
                  f"not to fit: {total / 1e9:.1f} GB")
            line(name, phase, analyze(cfg, shape, infer),
                 measured[phase]["device_ms"], measured[phase]["wall_ms"])
    for run in runs:
        cfg = run["cfg"]
        shape = ShapeConfig(f"train_b{run['batch']}_s{TRAIN_S}", TRAIN_S,
                            run["batch"], "train")
        foot = hbm_footprint(cfg, shape, train)
        label = f"{run['name']} ({cfg.n_layers} layers) B{run['batch']}"
        check(foot["fits"], f"{label} train predicted not to fit: "
              f"{foot['total'] / 1e9:.1f} GB")
        line(label, "train", analyze(cfg, shape, train), run["device_ms"],
             run["wall_ms"])
        pred_gib = foot["total"] / 2 ** 30
        print(f"[explore] {label} train footprint predicted {pred_gib:.2f} "
              f"GiB, measured peak {run['peak_gib']:.2f} GiB "
              f"(max_memory_allocated), measured/predicted "
              f"{run['peak_gib'] / pred_gib:.2f}x")

    mixtral = hbm_footprint(get_arch("mixtral-8x22b"), shapes["prefill"],
                            infer)
    moe24 = hbm_footprint(get_arch("qwen2-moe-a2.7b"), ShapeConfig(
        f"train_b{TRAIN_B}_s{TRAIN_S}", TRAIN_S, TRAIN_B, "train"), train)
    check(not mixtral["fits"], "mixtral-8x22b prefill predicted to fit")
    check(not moe24["fits"], "24-layer qwen2-moe training predicted to fit")
    print(f"[explore] predicted not to fit one card "
          f"({H100_SXM.hbm_bytes / 1e9:.0f} GB): mixtral-8x22b prefill B1 "
          f"S1024 {mixtral['total'] / 1e9:.1f} GB; qwen2-moe-a2.7b train, "
          f"24 layers, B{TRAIN_B} S{TRAIN_S} {moe24['total'] / 1e9:.2f} GB")

    shape = SHAPES["train_4k"]
    for name in served:
        cfg = get_arch(name)
        res = explore_gpu(cfg, shape)
        model = GPUModel(cfg, shape)
        evals = [model.evaluate(DesignPoint.make(log2_m=m, quant=q))
                 for m in range(7) for q in (0, 1)]
        best = max([r.efficiency for r in evals if r.feasible] or [0.0])
        check(math.isclose(res.best_fitness, best, rel_tol=DSE_RTOL)
              or res.best_fitness == best == 0.0,
              f"explore_gpu {name}: {res.best_fitness} vs exhaustive {best}")
        if best > 0:
            quant = res.search.best_point["quant"] >= 0.5
            print(f"[explore] explore_gpu {name} train_4k: best M "
                  f"{res.best_plan.microbatches}, "
                  f"{'int8' if quant else 'bf16'}, fitness "
                  f"{res.best_fitness:.4f} (roofline fraction) = exhaustive "
                  f"best of 14; front {len(res.pareto)} points, "
                  f"{res.search.unique_evaluations} evaluations")
        else:
            print(f"[explore] explore_gpu {name} train_4k: infeasible on "
                  f"one card ({res.search.best_result.reason}); fitness 0 "
                  f"= exhaustive best of 14")

    vgg = cnn_workload("vgg16")
    p1 = benchmark_paradigm(vgg, KU115, 1, batch=1).gops
    p2 = benchmark_paradigm(vgg, KU115, 2, batch=1).gops
    res = explore_fpga(vgg, KU115, batch=1, fix_batch=True, n_particles=12,
                       n_iters=10)
    p3 = res.best_design.gops()
    check(p3 >= PARADIGM3_SHARE * max(p1, p2),
          f"paradigm 3 {p3} GOP/s < {PARADIGM3_SHARE} x max({p1}, {p2})")
    print(f"[explore] vgg16 on KU115, batch 1, analytical GOP/s: paradigm 1 "
          f"{p1:.2f}, paradigm 2 {p2:.2f}, paradigm 3 (explore_fpga, split "
          f"{res.best_design.sp}) {p3:.2f} >= {PARADIGM3_SHARE} x "
          f"{max(p1, p2):.2f}")
    print(f"[explore] INT8_LOGIT_DEV_PROXY {INT8_LOGIT_DEV_PROXY} (the DSE's "
          f"int8 charge) vs measured bf16-vs-int8 KV max_logit_dev: "
          + ", ".join(f"{n} {d:.4f}" for n, d in int8_devs.items()))
    print(f"[explore] phase {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs only "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import ModelRuntime, cast_params, init_params

    # f32 comparisons must be full f32 (the defaults, set explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()

    def clock(phase):
        """Where the run's 1,200 s go: each phase's start on one clock."""
        print(f"[clock] {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # --- phase 1 ---------------------------------------------------------
    print(f"[device] {torch.cuda.get_device_name(0)}; count "
          f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    smi = smi_line()
    print(f"[device] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.library()
    print(f"[build] {lib_path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    build_log = (lib_path.parent / "build.log").read_text()
    for line in build_log.splitlines():
        spills = re.search(r"(\d+) bytes spill stores", line)
        if "registers" in line or (spills and int(spills.group(1))):
            print(f"[build] {line.strip()}")
    ptxas = _build.ptxas_entries(build_log)
    for kernel in (BF16_KERNEL, INT8_KERNEL):
        split_build_lines(ptxas, kernel)
    served_build_lines(ptxas, _build.SERVED_BUILDS)

    cfg = get_arch("minicpm-2b")
    moe_cfg, ssm_cfg = get_arch("qwen2-moe-a2.7b"), get_arch("mamba2-1.3b")
    hyb_cfg = get_arch("zamba2-2.7b")
    counters = kernel_counters()
    # --- phase 2 ---------------------------------------------------------
    clock("[kernels]")
    entries = kernel_phase(cfg, moe_cfg, ssm_cfg, hyb_cfg)
    clock("[graph]")
    graph = graph_start()
    dry = dryrun_start(graph)
    clock("[validator]")
    validator_phase()
    clock("[graph] results")
    graph_phase(graph)
    clock("[dryrun] host")
    ties = dryrun_phase(graph, dry)
    clock("[tune]")
    tuned = tuner_phase(counters)
    gc.collect()
    torch.cuda.empty_cache()

    # --- phase 3 ---------------------------------------------------------
    clock("[serve] minicpm-2b")
    t0 = time.perf_counter()
    rt = ModelRuntime()                   # bf16, cuda policy, on the card
    master = init_params(cfg, seed=0, device="cuda")
    params = cast_params(master, rt)
    del master
    torch.cuda.synchronize()
    print(f"[serve] minicpm-2b full width: {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B params in bf16, seeded init "
          f"{time.perf_counter() - t0:.1f} s")
    totals = [serve_phase(cfg, params, counters, rt)]
    served_measured = {cfg.name: profile_phase(cfg, params, rt)}
    traced, t_trace = trace_phase(cfg, params, rt, counters,
                                  served_measured[cfg.name])
    # --- phase 4 ---------------------------------------------------------
    int8_devs = {cfg.name: parity_phase(cfg, params)}
    clock("[graph] minicpm-2b launches")
    graphed = [graph_launches(cfg.name, cfg, params, rt, counters,
                              ((None, False), (None, True), ("int8", False),
                               ("int8", True)))]
    del params

    # --- phases 3 and 4: qwen2-moe-a2.7b, mamba2-1.3b, zamba2-2.7b --------
    for mcfg, expect, attention in (
            (moe_cfg, {"rmsnorm", "flash_attention", "moe_gemm"}, True),
            (ssm_cfg, {"rmsnorm", "ssd_scan"}, False),
            (hyb_cfg, {"rmsnorm", "flash_attention", "ssd_scan"}, True)):
        gc.collect()
        torch.cuda.empty_cache()
        clock(f"[serve] {mcfg.name}")
        t0 = time.perf_counter()
        mrt = ModelRuntime(moe_dropless=True)   # as the launcher serves
        params = init_params(mcfg, seed=0, rt=mrt)   # cast leaf by leaf
        torch.cuda.synchronize()
        print(f"[serve] {mcfg.name} full width: {mcfg.n_layers} layers, "
              f"{mcfg.param_count() / 1e9:.3f} B params in bf16, seeded "
              f"init {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
        hybrid = mcfg.family == "hybrid"
        scfg, sparams, label = mcfg, params, mcfg.name
        if mcfg.name in SERVE_RECURRENT_LAYERS:
            scfg = dataclasses.replace(
                mcfg, n_layers=SERVE_RECURRENT_LAYERS[mcfg.name])
            sparams = init_params(scfg, seed=0, rt=mrt)
            label = (f"{mcfg.name} ({scfg.n_layers} of {mcfg.n_layers} "
                     f"layers)")
        totals.append(serve_pair(
            label, scfg, sparams, mrt, counters, expect, attention,
            kv_dtypes=(None, "int8") if hybrid else (None,)))
        del sparams
        focus = {"moe": (("moe_gemm",), ("moe_gemm", BF16_KERNEL)),
                 "ssm": (SSD_KERNELS + ("ssd_",), ()),
                 "hybrid": (SSD_KERNELS + ("ssd_", "flash_fwd"),
                            (BF16_KERNEL,))}[mcfg.family]
        _, _, served_measured[mcfg.name] = profile_model(
            mcfg.name, mcfg, params, mrt, prefill_focus=focus[0],
            decode_focus=focus[1])
        held_out_prefills(mcfg, params, mrt)
        got, dt = trace_phase(mcfg, params, mrt, counters,
                              served_measured[mcfg.name])
        traced = {name: traced[name] + got[name] for name in counters}
        t_trace += dt
        int8_dev = {"moe": moe_parity, "ssm": ssm_parity,
                    "hybrid": hybrid_parity}[mcfg.family](mcfg, params)
        if int8_dev is not None:
            int8_devs[mcfg.name] = int8_dev
        clock(f"[graph] {mcfg.name} launches")
        graphed.append(graph_launches(
            mcfg.name, mcfg, params, mrt, counters,
            ((None, False),) if mcfg.family == "ssm"
            else ((None, False), (None, True))))
        del params
    # --- [families]: the last-ported families ------------------------------
    clock("[families]")
    fam_served, fam_traced, dt, fam_measured, fam_int8 = families_phase(
        counters)
    totals.append(fam_served)
    traced = {name: traced[name] + fam_traced[name] for name in counters}
    t_trace += dt
    served_measured.update(fam_measured)
    int8_devs.update(fam_int8)
    served = {name: sum(t[name] for t in totals) for name in counters}
    print(f"[serve] launches over all serving runs: {served}")
    graphed = {name: sum(t[name] for t in graphed) for name in counters}
    print(f"[graph] launches of the decode steps tied to their traces: "
          f"{graphed}")
    print(f"[trace] phase {t_trace:.1f} s (8 models x prefill and decode, "
          f"each traced on the card and on meta); launches {traced}")
    del totals

    # --- [launch]: the launcher's gates and the examples --------------------
    gc.collect()
    torch.cuda.empty_cache()
    clock("[launch]")
    launched = launch_phase(counters)

    # --- [sharded]: the sharded engines on meshes sharing the card ---------
    gc.collect()
    torch.cuda.empty_cache()
    clock("[dryrun] late")
    dryrun_late(graph, dry)
    clock("[sharded]")
    sharded = sharded_phase(counters, ties)

    # --- [sharded-zero3]: serving with the weights split over data --------
    gc.collect()
    torch.cuda.empty_cache()
    clock("[sharded-zero3]")
    zero3 = sharded_zero3_phase(counters, ties)
    sharded = {k: sharded[k] + zero3[k] for k in counters}

    # --- [sharded-train]: the sharded train step on meshes sharing the card
    gc.collect()
    torch.cuda.empty_cache()
    clock("[sharded-train]")
    sharded_train = sharded_train_phase(counters, ties)

    # --- phase 5 ---------------------------------------------------------
    clock("[train]")
    trained, train_runs = train_phase(counters)

    # --- phase 6 ---------------------------------------------------------
    clock("[explore]")
    explore_phase(served_measured, train_runs, int8_devs)
    capacity_phase()
    clock("the kernels line")

    # --- phase 7 ---------------------------------------------------------
    kernels = []
    for name, e in entries.items():
        e = dict(e, ok=True,
                 launches=(served[name] + tuned[name] + trained[name]
                           + traced[name] + launched[name]
                           + sharded[name] + sharded_train[name]
                           + graphed[name]),
                 launches_by_path={"serve": served[name],
                                   "tune": tuned[name],
                                   "train": trained[name],
                                   "trace": traced[name],
                                   "launch": launched[name],
                                   "sharded": sharded[name],
                                   "sharded_train": sharded_train[name],
                                   "graph": graphed[name]})
        e.pop("shape")
        for t in (e, *(e[k] for k in SUB_ENTRIES if k in e)):
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                check(t[key] is None or math.isfinite(t[key]),
                      f"{name} {key}")
        kernels.append(e)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
