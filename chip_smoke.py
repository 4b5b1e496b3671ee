#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

Run from the root of a checkout, with no environment set:

    python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself and imports nothing of JAX.  Each
phase prints one JSON line:

1. ``env``: the card's name and power limit from ``nvidia-smi``, torch and
   CUDA versions.
2. ``build``: the CUDA kernels compiled from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), with seconds and ptxas lines
   (registers, spills).  Then ``sass``: the tensor-core instructions in
   each built library's SASS, by kernel function and kind (``HMMA`` or
   ``HGMMA``, with bf16, TF32 or other operands:
   ``_build.tensor_core_counts``), where the toolkit has ``cuobjdump``.
   The bf16 kernels (``_build.BF16_TC_KERNELS``: ``flash_fwd_bf16`` and
   ``gemm_wgmma_bf16``) fail the run without their bf16 instruction
   (``HMMA.16816.F32.BF16``, ``HGMMA...BF16``) or with any TF32 product;
   the f32 wgmma kernels (``_build.TF32_WGMMA_KERNELS``:
   ``flash_fwd_wgmma_tf32x3``, ``gemm_wgmma_tf32x3``) without
   ``HGMMA...TF32`` or with any bf16 product; the SSD chunk kernel's mixed
   and bf16 functions (``_build.MIXED_TC_KERNELS``: ``ssd_chunk_mixed``,
   ``ssd_chunk_bf16``) without ``HMMA.BF16`` (their C Bᵀ; TF32 beside it
   is theirs); every other function that multiplies on the tensor cores
   without ``HMMA``: every other function of the three tensor-core sources
   and, in ``ssd_state.cu``, the walk's and the split outputs'
   (``ssd_state_walk``, ``ssd_state_out``); the GEMM's split transpose of
   B (``_build.NO_PRODUCT_KERNELS``: ``split_transpose_tf32``), the state
   scan and ``fused_eval.cu`` do no product on the tensor cores, so their
   counts are printed, not gated.  The build line carries each source's
   ptxas warnings (a serialized ``wgmma`` would show there).
3. ``kernel``: one line per kernel and shape.  Each kernel is held against
   its plain PyTorch version on the same inputs on the card, with TF32 off,
   at the tolerances of ``tests/test_kernels.py`` (GEMM atol 1e-3 /
   rtol 1e-4, flash 2e-5, SSD chunk 1e-4; the chunked SSD ``ssd_forward``
   at 2e-4; the SSD state pass, ``ssd_state_pass``, at 1e-4 on each route
   (forced): the walk, ``ssd_state_walk``, and the split,
   ``ssd_state_scan`` then ``ssd_state_out`` (``out_heads`` heads a
   block), each of those against its own plain version too, every launch
   counted; the model's chunked SSD through
   the SSD kernels at 2e-4; flash with ``q_offset = Sk - Sq``, the model's
   cache mode, in f32 and bf16; flash with its statistics (m, l) against
   the plain version's, and at Sk = 0 with no launch; attention with
   ``cache_stack`` through the kernel against ``use_kernels=False`` at 1e-4
   of the largest value).  The SSD chunk kernel is timed at the
   ``zamba2-1.2b`` and ``mamba2-370m`` serve waves' shapes and the
   realization's, in f32, bf16 and mixed (x and cum f32, B and C bf16:
   what the serve paths launch), and at an odd N (4-byte copies); every
   SSD line names the heads a block takes (``heads_per_block``); a head
   count that the heads a block do not divide is among the edges; the
   state pass at the
   ``zamba2-1.2b`` prefill, the ``mamba2-370m`` realization and serve
   shapes, on both routes, each kernel of the route also on its own.  Each
   kernel line names the kernel configuration the launch took (``route``:
   tile, head-dim template or P tile, copy width; for f32 the GEMM's and
   flash's TF32 wgmma kernels, ``... wgmma tma tf32x3``, on aligned
   operands and flash at D = 64 and 128, their mma.sync kernels
   elsewhere); the edge shapes drive each of them.  The GEMM's and flash's
   f32 lines say whether a second launch gave the same bits
   (``repeat_bit_equal``, gated), and at the path shapes time the parent's
   route too, the mma.sync kernel forced through ``tiled_matmul_sync_f32``
   and ``flash_attention_sync_f32`` on the same inputs (``parent_route``,
   ``parent_ms``, ``parent_max_abs_err``, held to the same tolerance, not
   counted).  The realization paths' shapes also get
   the kernel's time, the plain version's, one PyTorch library call's
   (``torch.matmul``, ``scaled_dot_product_attention``; none computes the
   SSD chunk form or the state pass, so their ``library_ms`` is null; for
   ``ssd_state_out`` at G = 1 the reference's own expression, ``y_intra
   + torch.einsum("bcqn,bchnp,bcqh->bcqhp", C, h_before, exp(cum))``,
   three calls: exp, einsum, add), each as device time
   (``time_ms``), the kernel's time also as the host issues it
   (``host_issued_ms``: above ``ms`` where the wrapper's host time per
   call exceeds the kernel's), and the least time the card could take:
   ``bound_ms`` at the f32 FMA peak (kept so that rows compare across
   versions), ``bound_3xtf32_ms`` at a third of the TF32 tensor-core
   peak, the rate of the arithmetic the tensor-core kernels use
   (``arith``: the three ported Pallas kernels, the state walk and the
   split's outputs; the state scan does no product).  Then one ``dtype:
   bf16`` line per kernel at every path shape and at ragged sizes (odd K
   and N; the wgmma GEMM off its tiles with a K tail; D = 40, 33, 36 and
   256, whisper's 448 x 1500; P = 130): bf16 operands, held against the
   plain version on the upcast inputs at the reference's bf16 tolerances
   (GEMM atol 0.5 / rtol 5e-2, flash 2e-2; SSD, whose outputs are f32,
   1e-4), each shape launched twice, each launch counted, the output
   type checked and the second launch's bits equal to the first's
   (``repeat_bit_equal``, also on the serve shapes' flash and SSD lines);
   ``dtype: mixed`` SSD lines likewise, at the serve and realization
   shapes and ragged sizes; at the path shapes
   also the kernel's, the plain version's and the bf16 library call's
   time and the bound at bf16 rates (989 TFLOP/s dense, 2 bytes an
   element).
4. ``path``, once per realization path: a committed keep_mappings
   checkpoint realized at full width through ``repro_torch.launch.realize
   --calibrate`` (one warm-up pass, then the counted pass, with every
   launch count set to 0 just before it): stages, kernel launches of the
   pass (the state pass's route's kernels once per SSD layer, after the
   chunk kernel; they must equal the plan's declared launches),
   wall, FLOPs, DCI bytes, argument bytes and scratch per stage
   (``arg_bytes``, which every stage must record; ``temp_bytes``, the
   card's allocator peak), the f32 GEMM and flash launches that took the
   TF32 wgmma kernels (``wgmma_f32_launches``, which must be all of them),
   the predicted totals
   (``pred_flops``, ``pred_dram_bytes``, ``pred_noc_bytes``,
   ``pred_d2d_bytes``, held to the pinned CPU values), the
   measured/predicted geomeans (``ratio_summary``), the fitted overlay,
   the host seconds of the predicted side (``predict_s``; the warm-up
   pass's apart), and the largest difference of every stage cube between
   the kernel route and the plain route given identical stage inputs.  A
   stage that launches a kernel with no predicted FLOPs, a ratio that is
   not finite, or an identity overlay that does not return its input
   Tech fails the run.  The paths are ``tf-paper`` (37 stages; GEMM and
   flash), ``mamba2-370m`` (96 stages; GEMM and the SSD chunk kernel),
   ``granite-moe-3b-a800m`` at full width and 2 of 32 layers (162 stages,
   166 GEMMs and 2 flash launches; routed MoE, realized as its dense
   equivalent, so the line carries the range of the dense-twin factors,
   ``expected_scale``) and ``mla-paper`` (5 stages, 16 GEMMs with low-rank
   shapes and 2 flash launches).
   Then ``loop``: the port's own DSE closes the paper's loop on
   ``tf-paper`` (``repro_torch.examples.realize_demo.close_loop``).  First
   the port's ``run_dse`` on ``simba_arch()`` must write the committed
   ``tf-paper`` fixture again (header equal; the record's arch, seed,
   workload and mapping equal; energy and delay within rel 1e-9).  Then a
   sweep of five 72-TOPS candidates of 36 cores (``LOOP_CANDIDATES``),
   exhaustive inside ``close_loop`` and once more with ``screen_keep=0.6``
   (the batched T-Map screen), whose survivors must score exactly as in
   the exhaustive sweep; the two best-EDP records realized on the card
   through the kernels and measured, each pass launching exactly its
   plan's kernels, every kernel stage predicted, every ratio finite, every
   stage cube within ``STAGE_REL_TOL`` of the plain route's; the fitted
   overlay; the identity-overlay second pass, bit-identical to the
   baseline in the same order; and the calibrated pass.  The line carries
   the DSE host seconds of each pass (host time of the machine the card
   sits in) and the phase's own seconds, the candidates and their
   objectives, the winner, per realized candidate its stages, launches,
   pass wall and ``ratio_summary``, the overlay, the calibrated objectives
   and whether the ranking changed.
   Then ``realize_mesh``: each plan stage on a sub-mesh of four ranks
   sharing the card over gloo.  The port's DSE writes a keep_mappings
   checkpoint (two 2 x 2-core archs, ``tf-paper`` at Table I width, batch
   4, SA 40 iterations, seed 0, numpy) into a temporary directory; ``python
   -m repro_torch.launch.realize --mesh 4 --host-ranks 4 --top 2
   --calibrate`` realizes its two best records (every rank must exit 0);
   then four ranks (``launch.mesh.start_local_ranks``, ``mesh_check_rank``)
   realize the same records and two hand-built plans (an SSD stage that
   splits batch and heads, a flash stage that splits query rows and heads:
   ``MESH_HAND_PLANS``) in mesh mode through the kernels, every launch count
   set to 0 just before each pass and read just after.  Gates: each rank's
   launches equal its part of the plan's; every stage cube, gathered,
   within ``STAGE_REL_TOL`` of the logical route's on the same seed; the
   DCI bytes the logical route's (and the report's); ``ici_bytes`` > 0 on
   some stage; the overlay's ``f_noc`` fitted (not 1.0) where a stage has
   both ICI and NoC bytes.  The line carries, per stage, ``n_devices``,
   ``ici_bytes`` against ``pred_noc_bytes``, ``coll_by_kind``, the slowest
   rank's wall and the launches summed over the ranks; the overlay, the
   collectives' ``transport`` and the seconds of the DSE, the CLI, the
   check and the phase.  ``kernel`` lines at the ranks' launch shapes
   (f32, ``main_path: "realize_mesh"``; flash with each rank's
   ``q_offset``, its library call SDPA with that causal mask).
   Then ``kernel`` lines of the cost model's two kernels (after the
   paths, so that the paths' host-bound passes run in the parent's
   conditions), on two layouts (the reference's fused-pass test arch with
   ``moe-quick``, S-Arch with the granite graph) at the batch of a
   lockstep SA iteration and of a screen: ``fused_eval`` held against its
   plain version on the card and the exact numpy engine (rel 1e-4, the
   same bottleneck, the reference's parity envelope), both through the
   wrapper on the batch's tensors and through the evaluator's own route
   (``eval_requests_batch(backend="fused")``); ``segment_replay``
   against ``np.bincount`` (rtol 2e-4 / atol 1e-2, and bit for bit: it
   adds each cell's entries in stream order) at 4, 64 and 200 rows, each
   stream launched 200 times for one distinct result; each with its device
   time, the plain version's, its time as the host issues it, the library
   call's (``index_add_`` for the replay, none for the fused pass), a
   bound from the bytes it must move at the HBM rate, and for the fused
   pass the real (unpadded) stream length, the parent version's bound on
   its padded stream, the block size and shared memory of the launch, the
   device time of an empty kernel (``launch_floor_ms``) and the host time
   of one whole batch evaluation on each backend.
   Then ``fused``: replica-exchange SA on the granite graph (S-Arch, four
   chains in lockstep), once on the exact numpy engine and once scoring
   proposals with the fused pass on the card, with the cost kernels'
   counts set to 0 just before (``fused_eval`` must launch once an
   iteration that has a proposal not in the cache: 198-200 times);
   proposals a second each way, each winner
   re-evaluated exactly (it must equal the reported cost to the bit); then
   ``analyze_requests(backend="fused")`` of a screen-sized batch through
   ``segment_replay``, equal to the exact replay bit for bit.
   Then ``sweep:quick`` and ``sweep:fused``: the supervised sweep
   (``repro_torch.launch.sweep_ctl launch``, two local shard children).
   ``sweep:quick`` is the reference's CI chaos sweep (the quick spec on
   the numpy engine) once for each fault kind (kill, stall, corrupt, dup,
   slow; fault seed 0), each of which must exit 0 and print
   ``verify-clean: OK`` (its merged records equal to a clean in-process
   run's, bit for bit).  ``sweep:fused`` sweeps ``tf-paper`` at its
   published width over the quick spec's 72-TOPS grid (6 candidates),
   replica-exchange SA of 4 chains x 200 iterations scoring on the fused
   pass, batch 8, 2 shards: one clean in-process ``run_dse`` on the card,
   then supervised runs with ``kill`` and with ``dup`` and tracing on
   (each child into its own run dir), each of which must merge with no
   candidate left and equal the clean run bit for bit (``fused_eval``
   sums in a fixed order, so the duplicate twins' records merge without
   conflict), its children's metrics snapshots showing
   ``group_eval_fused.misses`` and ``fused_eval.launches`` above 0, and
   ``obs_report`` rendering every run dir.  The lines carry the seconds
   of each run, candidates a second, the children's launches and one
   child's time-in-phase rows.
   Then ``serve``, twice: ``zamba2-1.2b`` at full width and depth (38
   layers, about 1.2 B parameters from the port's seeded ``init_params``,
   f32 parameters and bf16 compute), then ``mamba2-370m`` at full width
   and depth (48 layers, d 1024, N 128, about 0.37 B parameters), each
   served through ``repro_torch.runtime.serve_loop.Server``: 8 requests of
   300-1024 prompt tokens and 16 new tokens in two waves of 4 on a
   2048-position cache, after a short warm-up wave, with the launch counts
   set to 0 just before: requests, tokens, prefill seconds per wave, the
   median decode step, tokens a second, peak memory, and the launches,
   gated a wave at 7 flash, 38 SSD chunk and 38 state-pass walks
   (zamba2) and at 48 SSD chunk and 48 state-pass walks (mamba2-370m: the
   route the rule takes at 4 x 32 heads and N = 128); the first
   wave's prefill and 4 teacher-forced decode steps through the kernels
   against ``use_kernels=False`` on the card: within 2e-2 of the largest
   logit in f32 compute, and in the served bf16 compute within the larger
   of 2e-2 and the plain route's own bf16-vs-f32 gap (``serve_check``).
   Kernel lines at each serve phase's launch shapes (flash in bf16, the
   SSD kernels in f32) give their times.  Then ``serve:whisper-small``,
   the encoder-decoder at full width and depth (12 encoder and 12 decoder
   layers, d 768, 12 heads, vocab 51,865, about 0.24 B parameters), served
   the same requests (a wave's frames are its padded prompt length L, as
   the reference's serve loop gives them), its flash launches a wave gated
   at the reference's rule for that wave's L (12 encoder launches where L
   x L > 256 x 2048, 12 decoder self-attention launches where L x 2048
   is, 12 cross-attention launches where L x L is), the same kernel-vs-
   plain gates; then whisper's own shape, 4 clips of 1500 frames (30 s of
   audio) and 448 decoder tokens in one prefill: 24 flash launches (12 at
   1500 x 1500, 12 at 448 x 1500), the prefill and 4 decode steps against
   the plain route, and a kernel line at each of the two shapes.  Then
   ``serve_trace``: ``repro_torch.launch.serve --arch mamba2-370m --trace
   poisson:rate=8,n=16,plen=300..1024,new=16 --report --measure`` in this
   process, on the card; the two virtual sections (numpy on the host) held
   to the reference's values pinned in ``SERVE_TRACE_PINNED``, the
   measured replay through the port's ``ModelWaveExecutor`` answering all
   16 requests with each wave's launches gated (48 SSD chunk launches and
   48 of each kernel of the state pass's route at the wave's shape: the
   walk for a wave of 4, the split below); its line carries p50/p95/p99
   TTFT and end-to-end latency of each section, the saturation estimates,
   the measured/virtual p99 ratio and the phase's seconds.  Then
   ``serve_cli``: the two
   serving entry points, ``repro_torch.launch.serve`` and
   ``repro_torch.examples.serve_lm``, with ``--arch zamba2-1.2b`` at their
   defaults, and ``launch.serve --arch mamba2-370m``; each must answer
   every request.
   Then ``train``, twice: ``smollm-135m`` (30 layers, d 576, 9/3 heads,
   vocab 49,152, about 0.135 B parameters) and ``mamba2-370m`` at full
   width and depth (f32 parameters, bf16 compute, remat on), each trained
   by ``repro_torch.runtime.train_loop.Trainer`` at batch 4 and sequence
   1024 for 12 steps (AdamW lr 6e-4, warmup 2, cosine to step 12) with a
   checkpoint at step 6 and at the end, every launch count set to 0 just
   before; then the step-12 checkpoint dropped and steps 6-11 run again
   from the step-6 one (``run(resume=True)``).  Gates: the steps launch
   no kernel (the plain routes: the kernels have no backward); every loss
   and grad_norm finite; the mean of the last 3 losses below the mean of
   the first 3; the resumed losses equal to the straight run's within
   rel 1e-3 (the line says whether bit-equal).  Then the final parameters
   on the next batch through the kernels and the plain routes, in bf16
   and in f32 compute, no grad (``train_eval``): the launches exactly the
   eval's (30 flash for ``smollm-135m``; 48 SSD chunk and 48 of the state
   pass's route for ``mamba2-370m``), the kernel route's NLL and logits
   within the serve gate of the plain route's, and the kernel route under
   autograd refused.  Not gated: step ms (each and the median), tokens a
   second, peak memory, checkpoint save (blocking), wait and restore
   seconds and ``nvidia-smi``'s name and power limit.  Kernel lines at
   the eval's launch shapes (``main_path: "train:<arch>"``).  Then one
   ``profile`` line a trained model (not gated): one more train step
   under ``torch.profiler``, its device time, idle share against the
   median step and the kernels that take the most device time.
   Then ``pipeline``: ``smollm-135m`` at full width and depth (30 layers,
   d 576) planned by Gemini (``plan_for_graph`` of its layer graph at
   seq 1024 on ``mesh_as_arch(2, 2, 1)``, batch 4, 600 SA iterations:
   240 stages, as on the CPU; the SA's host seconds) and executed by
   ``repro_torch.runtime.pipeline.PipelineExec`` on the card, tokens
   (4, 1024) in 2 microbatches, in bf16 compute (the main path: launch
   counts set to 0 just before, read just after; exactly 60 flash
   launches, 30 blocks x 2 microbatches, no other kernel) and in f32;
   the logits within 0.05 (bf16; against the plain route the larger of
   that and the plain route's own bf16-vs-f32 gap) and atol = rtol =
   2e-3 (f32) of the monolithic forward through the kernels and through
   the plain route; the pass wall and each stage's seconds; then
   ``repro_torch.examples.map_to_mesh`` at its defaults, which must print
   ``(OK)``.  Kernel lines at the pipeline's flash shape (bf16, 2 x 9
   heads x 1024 x 1024).  Then ``dp``: ``make_compressed_dp_step`` on a
   one-rank NCCL mesh on the card (``launch.mesh.make_host_mesh``, which
   starts its own group), the reference's 60-step regression (the last
   loss below 0.05 x the first), and ``compressed_grad_sync`` of one rank
   equal to its int8 ``q * scale`` and residual bit for bit.
   Then ``cells``: the cell bundles of ``repro_torch.launch.steps`` on a
   one-rank NCCL mesh (``make_host_mesh((1, 1))``, its own group) against
   the eager route, at full width and depth from seeded weights:
   ``smollm-135m`` and ``mamba2-370m`` each through ``make_prefill_bundle``
   (4 x 4096 tokens, bf16 weights) and 16 greedy ``make_decode_bundle``
   steps (the eager route's tokens fed), each route run twice and the
   second counted, launch counts set to 0 just before: the bundles'
   launches must equal the eager route's and the plan's (30 flash;
   48 SSD chunk and 48 of the state pass's route), and every step's
   logits be within 2e-2 of the largest eager logit (bit-equal is what a
   rank of one gives, and the line says whether it held; the greedy
   tokens must then be equal too); then ``smollm-135m`` trained 12 steps
   (4 x 1024, f32 parameters, bf16 compute, remat) by ``make_train_step``
   and by ``make_train_bundle`` with ``zero1`` on and off from the same
   weights on the same batches: every loss within rel 1e-5 of the eager
   step's, and no kernel launched.  Not gated: prefill seconds, decode ms
   a step and train step ms of both routes, peak memory.  Kernel lines at
   the prefills' launch shapes (``main_path: "cells:<arch>"``).  Then
   ``dryrun``: ``python -m repro_torch.launch.dryrun`` in a subprocess on
   the host's CPU (started before ``cells``, read after it, killed past
   ``DRYRUN_TIMEOUT``): ``smollm-135m``'s three cells and
   ``mamba2-370m``'s ``long_500k`` on the single-pod mesh (a fake
   256-rank group), each ``ok`` with its three roofline terms at the H100
   rates, bottleneck and memory; a failed cell fails the run.
   Then ``profile`` (not gated): the timed ``ops.ssd_forward`` call at the
   ``mamba2-370m`` SSD layer's shape once more, under ``torch.profiler``:
   the device time of its kernels, the device's idle share over its
   host-issued wall, and kernel launches and device time split between
   the chunk kernel, the state pass (``recurrence_launches``; its route
   and kernels) and the rest of the eager glue.
5. ``kernels``: every kernel (the state pass's three apart) with its launches
   on the paths, the loop, the serve phases and the train phases' eval
   forwards, its numbers summed over one pass of each path, of each realized
   loop candidate (``loop#1``, ``loop#2``), of each serve phase (``serve``,
   ``serve:mamba2-370m``, ``serve:whisper-small``, ``serve_trace``) and of each
   train phase's eval forward (``train:smollm-135m``, ``train:mamba2-370m``),
   of the pipelined forward (``pipeline:smollm-135m``), of the cell
   bundles' prefills (``cells:smollm-135m``, ``cells:mamba2-370m``) and of
   each mesh rank's passes (``realize_mesh:r0`` to ``:r3``), and each one's
   share apart (both bounds, ``arith``), for the GEMM and flash each
   path's routes by launch and the parent kernel's ms, and the launches
   split by the kernel function they took (``functions``:
   ``gemm_wgmma_tf32x3`` and ``gemm_3xtf32``, ``flash_fwd_wgmma_tf32x3``
   and ``flash_fwd``); under ``bf16`` the realization
   launches' sums with bf16 operands.  The cost model's two kernels carry their
   launches in the ``fused`` phase and in the fused sweep's shard children
   (``per_path``: ``fused``, ``sweep:fused``, read from the children's metrics
   snapshots) and one launch's numbers at the ``fused`` phase's shape.

Then the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero without that line; without a card, or outside a checkout,
it exits non-zero before printing anything.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
FIXTURES = ROOT / "tests" / "data" / "realize"
REPORTS = ROOT / "results"

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, dense TF32 and bf16 on the tensor cores, and HBM3 bandwidth.
# Every product of the kernels is taken in 3xTF32 (three TF32 products per
# f32 product, f32 accuracy); with bf16 operands, which are exact in TF32,
# a product of two of them is one TF32 product and a product with an
# operand computed in f32 two.
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
# float64 outside the tensor cores (NVIDIA data sheet, H100 SXM): the rate
# of segment_replay's adds
PEAK_F64_FLOPS = 34e12
ARITH = {"tiled_matmul": "3xTF32: TF32 wgmma m64nNk8 fed by TMA, B split "
                         "and transposed first (K, N % 4 == 0, aligned); "
                         "else mma.sync m16n8k8",
         "flash_attention_mha": "3xTF32: TF32 wgmma m64nNk8 fed by TMA (D 64 "
                                "or 128, aligned); else mma.sync m16n8k8",
         "ssd_chunk_dual": "3xTF32 mma.sync (C B^T once a block of heads)",
         "ssd_state_walk": "3xTF32 mma.sync",
         "ssd_state_scan": "f32 FMA (no tensor cores)",
         "ssd_state_out": "3xTF32 mma.sync"}
# the wrappers whose f32 launches take a TF32 wgmma kernel where the
# operands allow (``wgmma_f32_launches``): on the realization paths, all
WGMMA_F32 = ("tiled_matmul", "flash_attention_mha")
# the state pass's kernels, by route (repro_torch.kernels.ssd_state)
STATE_KERNELS = ("ssd_state_walk", "ssd_state_scan", "ssd_state_out")
# the kernel functions of ssd_state.cu whose SASS must hold HMMA: the
# two that take the product C . h (the scan takes none); every function
# of _build.TENSOR_CORE_SOURCES must too, none of fused_eval.cu
STATE_HMMA_KERNELS = ("ssd_state_walk", "ssd_state_out")
ARITH_BF16 = {
    "tiled_matmul": "bf16 wgmma m64nNk16, f32 accumulation, TMA-fed "
                    "(ragged K or N: 1 TF32 mma.sync a product)",
    "flash_attention_mha": "bf16 mma.sync m16n8k16, f32 accumulation: 1 "
                           "for QK^T, 2 for PV (P split into bf16 hi and "
                           "lo)",
    "ssd_chunk_dual": "bf16 inputs, f32 math and outputs: bf16 mma.sync "
                      "m16n8k16 for CB^T (once a block of heads, each k16 "
                      "step added in f32), 2 TF32 mma.sync for Wx and "
                      "(dB)^T x"}
# the SSD chunk kernel's mixed instance, which the serve, train-eval and
# cell paths launch (the model computes in bf16: x and cum f32, B and C
# bf16)
ARITH_MIXED = ("x and cum f32, B and C bf16: bf16 mma.sync m16n8k16 for "
               "CB^T (once a block of heads, each k16 step added in f32), "
               "3xTF32 mma.sync for Wx and (dB)^T x")

MM_TOL = {"atol": 1e-3, "rtol": 1e-4}
FLASH_TOL = {"atol": 2e-5, "rtol": 2e-5}
SSD_TOL = {"atol": 1e-4, "rtol": 1e-4}
SSD_FORWARD_TOL = {"atol": 2e-4, "rtol": 2e-4}
# bf16 operands against the plain version on the upcast inputs, at the
# reference's bf16 tolerances (tests/test_kernels.py: GEMM atol 0.5 /
# rtol 5e-2, flash 2e-2); the reference has no bf16 SSD test, and the SSD
# kernel returns f32 with bf16 inputs exact in f32, so it keeps 1e-4
MM_BF16_TOL = {"atol": 0.5, "rtol": 5e-2}
FLASH_BF16_TOL = {"atol": 2e-2, "rtol": 2e-2}
SSD_BF16_TOL = SSD_TOL
# cycles of the sleep kernel ahead of a device timing: 5 ms at 2 GHz, more
# than the host takes to queue 20 calls of any function timed that way
SLEEP_CYCLES = 10_000_000
# per-stage cube agreement, relative to the cube's max (tests/test_realize.py)
STAGE_REL_TOL = 2e-4

MM_PATH = [(2048, 512, 512), (2048, 512, 2048), (2048, 2048, 512),
           (4096, 1024, 4384), (4096, 2048, 1024),
           # granite-moe-3b-a800m: router (N = 40), experts' up and down,
           # attention output, qkv
           (4096, 1536, 40), (4096, 1536, 1024), (4096, 512, 1536),
           (4096, 1536, 1536), (4096, 1536, 2560),
           # mla-paper: the low-rank down/up projections, output, FFN
           (1024, 512, 64), (1024, 512, 128), (1024, 64, 512),
           (1024, 128, 512), (1024, 512, 512), (1024, 512, 2048),
           (1024, 1024, 512)]
# (M, K, N, A one float into its storage): ragged shapes; both tile
# configurations with 16-byte copies (the path's shapes) and with 4-byte
# copies (K or N % 4 != 0, or A not 16-byte aligned)
MM_EDGE = [(100, 300, 50, False), (257, 129, 65, False),
           (1000, 77, 3, False), (64, 64, 64, False),
           (2048, 130, 2050, False), (512, 256, 512, True),
           (2048, 512, 2048, True),
           # the TF32 wgmma kernel's tiles off their multiples, a K tail
           (1000, 516, 1020, False), (333, 260, 68, False),
           (4100, 1532, 36, False)]
FLASH_PATH = [(4, 4, 512, 512, 128, True), (1, 12, 4096, 4096, 128, True),
              (2, 4, 512, 512, 128, True)]
# (B, H, Sq, Sk, D, causal, q one float into its storage): every head-dim
# template (32, 64, 128, 256), Sq != Sk causal both ways, 4-byte copies
# (D % 4 != 0, q not 16-byte aligned)
FLASH_EDGE = [(2, 4, 96, 96, 64, True, False),
              (1, 2, 128, 256, 32, False, False),
              (1, 2, 100, 300, 64, True, False),
              (1, 2, 256, 128, 32, True, False),
              (2, 3, 70, 45, 100, False, False),
              (1, 2, 130, 130, 256, True, False),
              (1, 2, 96, 200, 256, True, False),
              (2, 2, 192, 100, 128, True, False),
              (1, 3, 80, 90, 33, True, False),
              (1, 2, 64, 96, 64, True, True),
              (2, 3, 70, 45, 64, False, False),
              (2, 3, 70, 45, 128, True, False)]
# (BC, Q, H, P, N, x one float into its storage): the mamba2-370m path's
# shape; tests/test_kernels.py's three; ragged chunk lengths; P of 32 and
# 64; two P tiles with N off 4; then, each at an odd number of (chunk,
# head) blocks: 4-byte copies (x not 16-byte aligned), Q of 70 and 100,
# N % 8 != 0 and P = 130
SSD_PATH = [(32, 128, 16, 128, 64, False)]
# zamba2-1.2b's serve wave (4 slots of up to 1024 tokens: 64 heads of P =
# 64, N = 64), timed
SSD_SERVE = [(32, 128, 64, 64, 64, False)]
# the N <= 128 instance (N128 P64), timed: the mamba2-370m serve wave's
# shape (4 slots of up to 1024 tokens) and an odd N past 64 (4-byte
# copies); then edges: N = 100 with 16-byte copies, x a float off 16 B, P
# = 130 in three tiles, Q off 16
SSD_WIDE = [(32, 128, 32, 64, 128, False), (32, 128, 32, 64, 99, False)]
SSD_WIDE_EDGE = [(2, 128, 3, 64, 100, False), (1, 100, 5, 64, 128, True),
                 (1, 128, 3, 130, 72, False), (3, 70, 3, 64, 99, False),
                 (8, 100, 37, 64, 128, False)]
SSD_EDGE = [(2, 16, 2, 8, 4, False), (4, 64, 4, 32, 16, False),
            (1, 128, 8, 64, 32, False), (2, 96, 4, 64, 64, False),
            (3, 70, 2, 32, 16, False), (2, 70, 3, 130, 50, False),
            (3, 70, 3, 64, 16, True), (1, 100, 5, 64, 64, False),
            (3, 100, 1, 32, 12, False), (1, 128, 3, 130, 20, False),
            (1, 70, 7, 60, 50, True),
            # 37 heads, 3 a block by the grid-fill rule: a last group of 1
            (8, 128, 37, 64, 64, False)]
# bf16 at ragged sizes: the GEMM's one-element (ld2) route at odd K and
# odd N; SSD at P = 130 and N % 8 != 0
MM_BF16_EDGE = [(257, 129, 65), (2048, 131, 2048), (1000, 64, 77),
                # the wgmma route off its tiles: M and N ragged, a K tail
                # (72, 4104 = 64 * 64 + 8), N of 40
                (1000, 72, 200), (300, 4104, 136), (100, 64, 40)]
# and flash's: D = 40 (16-byte copies off the template), D = 33 and 36
# (one-element copies), whisper's 448 x 1500 (Sk off the kv tile), D = 256
FLASH_BF16_EDGE = [(2, 2, 100, 70, 40, True), (1, 2, 70, 70, 33, True),
                   (1, 3, 80, 90, 36, False), (2, 12, 448, 1500, 64, False),
                   (1, 2, 96, 200, 256, True)]
SSD_BF16_EDGE = [(1, 128, 3, 130, 24), (2, 16, 2, 8, 4),
                 (2, 128, 3, 64, 100), (1, 100, 5, 130, 128),
                 (8, 128, 37, 64, 64)]
# the mixed instance (x and cum f32, B and C bf16) at ragged sizes: N % 8
# != 0 and x a float off 16 bytes (one-element copies), Q off 16, P = 130,
# a ragged last group of heads, N = 99 and 100
SSD_MIXED_EDGE = [(2, 16, 2, 8, 4, False), (1, 70, 7, 60, 50, True),
                  (1, 100, 5, 130, 128, False), (8, 128, 37, 64, 64, False),
                  (3, 70, 3, 64, 99, False), (2, 128, 3, 64, 100, False),
                  (8, 100, 37, 64, 128, False)]
# ssd_forward, kernel vs plain: (B, L, H, P, N, chunk); a padded last
# chunk, and the mamba2-370m path's SSD layer (timed: the chunk kernel and
# the state pass plus the eager discretization and cumsum around them)
SSD_FORWARD = [(2, 70, 4, 64, 32, 32), (1, 4096, 16, 128, 64, 128)]
# the SSD state pass: (B, nc, Q, H, P, N, G, init) at the zamba2-1.2b
# layer's shape (a 1024-token wave of 4), the mamba2-370m realization
# shape and its serve wave's (timed, each on both routes: the walk and the
# split, forced), then edges, each on both routes: nc = 1, an initial
# state, G = 2 and 3, P and N off 4 (4-byte copies), N = 128; and two with
# enough blocks that a block of the split's outputs takes 4 heads (G = 3,
# Q, P and N ragged) and 2 (G = 8); Q = 200, past one round of rows
STATE_PATH = [(4, 8, 128, 64, 64, 64, 1, False),
              (1, 32, 128, 16, 128, 64, 1, False),
              (4, 8, 128, 32, 64, 128, 1, False)]
STATE_ROUTES = ("walk", "split")
STATE_EDGE = [(2, 1, 128, 4, 64, 32, 1, False),
              (2, 3, 128, 8, 64, 64, 1, True),
              (2, 3, 70, 4, 130, 50, 2, True),
              (1, 5, 128, 6, 32, 128, 3, True),
              (2, 4, 100, 4, 64, 13, 2, False),
              (4, 8, 100, 12, 130, 50, 3, True),
              (4, 8, 70, 16, 64, 13, 8, False),
              (1, 3, 200, 4, 64, 64, 1, True)]
STATE_TOL = SSD_TOL
# the model's chunked SSD through the kernels against its plain version at
# the config's chunk (B, L, H, P, G, N, chunk, init): L off the chunk, an
# initial state, G = 2 (the chunk kernel once per group)
CHUNKED = [(2, 300, 8, 64, 1, 32, 256, False),
           (2, 512, 8, 64, 2, 32, 256, True),
           (1, 1000, 64, 64, 1, 64, 256, True)]
# flash with q_offset = Sk - Sq (the model's cache mode), f32 and bf16
FLASH_OFFSET = [(2, 4, 128, 384, 64), (1, 32, 300, 1000, 64),
                (1, 2, 70, 200, 128)]
# flash with its statistics (m, l) against the plain version's, f32 and
# bf16: (B, H, Sq, Sk, D, causal, q_offset): the cache mode, top-left
# causal, not causal off the head-dim template, the 256 template; then
# Sk = 0 (no launch).  Then attention with cache_stack on the card against
# use_kernels=False at (pos, S) (the old cache empty at pos 0), f32
# compute, within CACHE_STACK_TOL (flash's 2e-5 through the merge and the
# output projection)
FLASH_STATS = [(2, 4, 128, 384, 64, True, 256), (1, 2, 100, 300, 64, True, 0),
               (2, 3, 70, 45, 100, False, 0), (1, 2, 130, 130, 256, True, 0)]
CACHE_STACK = [(0, 1024), (512, 768)]
CACHE_STACK_TOL = 1e-4

# the realization paths: (name, fixture, workload binding, stages,
# launches of one pass, counted FLOPs of one pass, predicted totals of one
# pass).  The predicted totals are the port's CPU values, which
# tests/test_torch_cost_model.py holds equal to the reference's.
PATHS = [
    ("tf-paper", "tf-paper.simba.ckpt.jsonl", "TF=tf-paper", 37,
     {"tiled_matmul": 36, "flash_attention_mha": 6, "ssd_chunk_dual": 0,
      "ssd_state_walk": 0, "ssd_state_scan": 0, "ssd_state_out": 0},
     83_764_445_184,
     {"pred_flops": 90_244_644_864.0, "pred_noc_bytes": 109_003_176.0,
      "pred_d2d_bytes": 2_166_178_741.0, "pred_dram_bytes": 325_844_992.0}),
    ("mamba2-370m", "mamba2-370m.simba.ckpt.jsonl", "MAMBA=lm:mamba2-370m",
     96, {"tiled_matmul": 96, "flash_attention_mha": 0, "ssd_chunk_dual": 48,
          "ssd_state_walk": 0, "ssd_state_scan": 48, "ssd_state_out": 48},
     2_694_970_343_424,
     {"pred_flops": 3_002_987_446_272.0, "pred_noc_bytes": 3_068_313_600.0,
      "pred_d2d_bytes": 77_788_781_360.0,
      "pred_dram_bytes": 11_575_820_288.0}),
    # full width, 2 of 32 layers (the search grows faster than linearly
    # with depth and every layer repeats the same 81 stages); routed MoE,
    # so the measured side takes the dense-twin factors and its FLOPs are
    # host float64 like the predicted totals
    ("granite-moe-3b-a800m", "granite-moe-3b-a800m.simba.ckpt.jsonl",
     "GRANITE=lm:granite-moe-3b-a800m:seq=4096,n_layers=2", 162,
     {"tiled_matmul": 166, "flash_attention_mha": 2, "ssd_chunk_dual": 0,
      "ssd_state_walk": 0, "ssd_state_scan": 0, "ssd_state_out": 0},
     516_646_945_745.7445,
     {"pred_flops": 1_501_086_036_787.2,
      "pred_noc_bytes": 3_561_259_827.200001,
      "pred_d2d_bytes": 60_090_000_009.60001,
      "pred_dram_bytes": 10_500_748_083.2}),
    ("mla-paper", "mla-paper.simba.ckpt.jsonl", "MLA=mla-paper", 5,
     {"tiled_matmul": 16, "flash_attention_mha": 2, "ssd_chunk_dual": 0,
      "ssd_state_walk": 0, "ssd_state_scan": 0, "ssd_state_out": 0},
     9_531_555_840,
     {"pred_flops": 12_155_092_992.0, "pred_noc_bytes": 18_646_016.0,
      "pred_d2d_bytes": 395_304_640.0, "pred_dram_bytes": 32_178_176.0}),
]
# the predicted totals are host float64 sums; a numpy that groups its
# pairwise sums differently may move the last bits
PRED_REL_TOL = 1e-9
# the loop phase: the fixtures' DSE settings, and five 72-TOPS candidates
# of 36 cores (names of repro_torch.core.hw presets and their replacements)
LOOP_WORKLOAD = ("TF", "tf-paper")
LOOP_CANDIDATES = [("simba_arch", {}), ("gemini_arch_72t", {}),
                   ("gemini_arch_72t", {"xcut": 3, "ycut": 2}),
                   ("gemini_arch_72t", {"d2d_bw": 8.0}),
                   ("simba_arch", {"glb_kb": 2048})]
LOOP_TOP = 2
LOOP_SCREEN_KEEP = 0.6
# the realize_mesh phase: a pool of four ranks sharing the card over gloo;
# the port's DSE on two 2 x 2-core archs (the CPU tests' checkpoint, at
# tf-paper's Table I width), its two best records realized; then the same
# records and two hand-built plans (repro_torch.realize.plan.hand_plans,
# as the CPU tests build them: an SSD stage that splits batch and heads, a
# flash stage that splits query rows and heads) checked rank by rank
MESH_RANKS = 4
MESH_WORKLOAD = ("TF", "tf-paper")
MESH_SA_ITERS = 40
MESH_TOP = 2
MESH_TIMEOUT = 300
MESH_HAND_PLANS = ("ssd", "flash")      # of realize.plan.hand_plans
# the cost model's kernels: the fused phase's SA (replica exchange on the
# granite graph, S-Arch, the fixtures' batch), its lockstep batch (one
# proposal a chain) and a screen-sized batch; the layouts of the kernel
# lines (the reference's fused-pass test arch with moe-quick, S-Arch with
# granite, and the sweep's: below); the reference's tolerances
# (tests/test_fused_eval.py: rel 1e-4 for the fused pass, rtol 2e-4 /
# atol 1e-2 for the replay)
FUSED_SPEC = "lm:granite-moe-3b-a800m:seq=4096,n_layers=2"
FUSED_TOTAL_BATCH = 4
FUSED_CHAINS = 4
FUSED_ITERS = 200
FUSED_B = (FUSED_CHAINS, 64)
ZOO_ARCH = dict(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=16.0,
                d2d_bw=8.0, dram_bw=64.0, glb_kb=512, macs_per_core=256)
FUSED_REL_TOL = 1e-4
REPLAY_TOL = {"rtol": 2e-4, "atol": 1e-2}
# segment_replay's lines: the lockstep batch, a screen, and more rows than
# the card has SMs; each stream replayed REPLAY_REPS times must give one
# result, equal to np.bincount's bits
REPLAY_B = (FUSED_CHAINS, 64, 200)
REPLAY_REPS = 200
COST_KERNEL_FILES = {
    "fused_eval": ("src/repro_torch/kernels/csrc/fused_eval.cu",
                   "src/repro/core/evaluator.py:97"),
    "segment_replay": ("src/repro_torch/kernels/csrc/fused_eval.cu",
                       "src/repro/core/analyzer.py:60"),
}
# the sweep phase: the supervised sweep (repro_torch.launch.sweep_ctl), two
# local shard children.  sweep:quick is the reference's CI chaos sweep (the
# quick spec, numpy) once for each fault kind, fault seed 0, merged and
# held bit-identical to a clean in-process run (--verify-clean); a short
# heartbeat deadline keeps the stall kind's wait short.  sweep:fused is the
# paper's Table-I Transformer at its published width (tf-paper) on the
# quick spec's 72-TOPS grid (6 candidates: the grid_candidates options of
# quick_spec, of the 2,700 of the full 72-TOPS grid), replica-exchange SA
# of 4 chains x 200 iterations scoring on the fused pass (fused_eval on the
# card), batch 8, 2 shards: one clean in-process run_dse on the card, then
# supervised runs with each of SWEEP_FUSED_FAULTS and tracing on, each
# child tracing into its own run dir under the supervisor's
SWEEP_QUICK_ARGV = ["--quick", "--hosts", "2", "--fault-seed", "0",
                    "--hb-timeout", "10", "--poll", "0.15", "--verify-clean"]
SWEEP_FUSED_SPEC = {
    "workloads": {"tf": "tf-paper"},
    "grid": dict(tops=72.0, mac_options=[512, 1024], cut_options=[1, 2],
                 dram_per_tops=[2.0], noc_options=[16, 32], d2d_ratio=[0.5],
                 glb_options=[1024]),
    "sa": dict(iters=200, seed=0, n_chains=4, backend="fused"),
    "cfg": dict(batch=8), "n_shards": 2}
SWEEP_FUSED_FAULTS = ("kill", "dup")
# the serve phase: zamba2-1.2b at full width and depth (38 Mamba-2 layers,
# the shared attention block applied every 6: 7 times), then mamba2-370m
# at full width and depth (48 Mamba-2 layers, d 1024, 32 heads of 64, N
# 128), parameters from the port's seeded init_params on the card (f32
# params, bf16 compute); a Server of 4 slots and a 2048-position cache
# answers 8 requests of 300-1024 prompt tokens (every prefill of zamba2
# takes the flash path: Sq * 2048 > 256 * 2048) and 16 new tokens each.
# Each wave launches, per SERVE_ARCHS, the flash kernel once an attention
# application, the SSD chunk kernel once a Mamba-2 layer and the kernels
# of the route the state pass takes once a Mamba-2 layer (zamba2's waves
# of 4: the walk, 256 blocks at two an SM; mamba2-370m's: the walk too,
# 128 blocks at one an SM); decode takes the scores path and the recurrent
# update.  The first wave's prefill and 4 teacher-forced decode steps
# through the kernels against use_kernels=False on the card, within 2e-2
# of the largest logit (the reference's bf16 serving tolerance) in f32
# compute; in the served bf16 compute within the larger of 2e-2 and the
# plain route's own bf16-vs-f32 gap (bf16 rounding, amplified over 38
# random-init layers, moves the logits by more than 2e-2: serve_check)
SERVE_ARCH = "zamba2-1.2b"
# arch -> (flash launches a wave, Mamba-2 layers, attention heads and head
# dim of the flash launches, SSD heads, head dim P and state width N)
SERVE_ARCHS = {"zamba2-1.2b": (7, 38, 32, 64, 64, 64, 64),
               "mamba2-370m": (0, 48, 0, 0, 32, 64, 128)}
SERVE_REQUESTS = 8
SERVE_MAX_BATCH = 4
SERVE_MAX_SEQ = 2048
SERVE_MAX_NEW = 16
SERVE_PROMPT = (300, 1024)
SERVE_CHECK_STEPS = 4
SERVE_TOL = 2e-2
# the reference's rule for the flash path (src/repro/nn/attention.py:160):
# Sq * Sk above it, over the full key length
FLASH_RULE = 256 * 2048
# the encoder-decoder served at full width and depth (whisper-small,
# arXiv:2212.04356): arch -> (encoder layers, decoder layers, d_model,
# heads, head dim, d_ff, vocab).  It serves the same requests (a wave's
# frames are its padded prompt length L, as the reference's serve loop
# gives them); its flash launches a wave follow the rule at that wave's L
# (serve_wave_keys).  Then whisper's own shape: WHISPER_SLOTS clips of
# 1500 frames (30 s of audio) and 448 decoder tokens in one prefill
SERVE_ENCDEC = {"whisper-small": (12, 12, 768, 12, 64, 3072, 51865)}
WHISPER_SLOTS = 4
WHISPER_FRAMES = 1500
WHISPER_TEXT = 448
# the serve phases, in order
SERVE_PHASES = (*SERVE_ARCHS, *SERVE_ENCDEC)
# serve_trace: the trace-replay entry point on the card, its virtual
# sections held to the reference's values (tests/test_torch_serve_trace.py
# holds these equal to both packages' CPU output)
SERVE_TRACE_ARCH = "mamba2-370m"
SERVE_TRACE_SPEC = "poisson:rate=8,n=16,plen=300..1024,new=16"
SERVE_TRACE_ARGV = ["--arch", SERVE_TRACE_ARCH, "--trace", SERVE_TRACE_SPEC,
                    "--max-batch", str(SERVE_MAX_BATCH), "--max-seq",
                    str(SERVE_MAX_SEQ), "--report", "--measure"]
SERVE_TRACE_PINNED = {
    "serve_loop": {
        "ttft_s.p50": 2.370865802182241, "ttft_s.p95": 3.573761805509585,
        "ttft_s.p99": 3.585983146676628, "e2e_s.p50": 2.401203399622241,
        "e2e_s.p95": 3.604099402949585, "e2e_s.p99": 3.616320744116628,
        "makespan_s": 5.864257585152,
        "saturation.sat_rate_rps": 5880.577219754148,
        "saturation.sat_throughput_tok_s": 43.65428978566338},
    "realized": {
        "ttft_s.p50": 0.00028239999999990495,
        "ttft_s.p95": 0.0004068999999999323,
        "ttft_s.p99": 0.0004090599999999944,
        "e2e_s.p50": 0.00028839999999841215,
        "e2e_s.p95": 0.00041290000000010485,
        "e2e_s.p99": 0.00041506000000016694,
        "makespan_s": 2.4228904337275288,
        "saturation.sat_rate_rps": 5880.577219754148,
        "saturation.sat_throughput_tok_s": 54452.36881143569}}

# train: two models at full width and depth trained through
# repro_torch.runtime.train_loop.Trainer (the launcher's), f32 parameters
# and bf16 compute as configured, remat on, at the reference example's
# batch of 4 (examples/train_lm.py) and sequence 1024, where the
# reference's rule takes the block-scan (flash) path (Sq * Sk > FLASH_RULE;
# at the example's 512 neither the step nor the eval forward would reach
# it).  AdamW as the example sets it (lr 6e-4), warmup 2, cosine over the
# phase's TRAIN_STEPS.  The step takes the plain routes (the kernels have
# no backward; the reference differentiates its jnp twins) and must launch
# no kernel.  A straight run of TRAIN_STEPS checkpoints at the middle;
# the second half runs again from that checkpoint and must give the
# straight run's losses within TRAIN_RESUME_RTOL (the line says whether
# bit-equal).  Then the final parameters evaluate the next batch once
# through the kernels (no grad): the loss within the serve gate of the
# plain route's, the launches exactly the eval's plan (train_eval_keys).
# arch -> (layers, d_model, heads, kv heads, head dim, vocab) of the
# config; the SSD model's SSD numbers are in SERVE_ARCHS
TRAIN_ARCHS = {"smollm-135m": (30, 576, 9, 3, 64, 49152),
               "mamba2-370m": (48, 1024, 32, 32, 32, 50280)}
TRAIN_BATCH = 4
TRAIN_SEQ = 1024
TRAIN_STEPS = 12
TRAIN_LR = 6e-4
TRAIN_WARMUP = 2
TRAIN_RESUME_RTOL = 1e-3


# the pipeline phase: smollm-135m at full width and depth (layers, d,
# heads, kv heads, head dim, d_ff, vocab), its Gemini plan at seq 1024 on
# the 2 x 2 abstract mesh (240 stages, as on the CPU), 4 x 1024 tokens in 2
# microbatches; gates: the example's 0.05 in bf16, the reference test's
# 2e-3 in f32
PIPELINE_ARCH = "smollm-135m"
PIPELINE_DIMS = (30, 576, 9, 3, 64, 1536, 49152)
PIPELINE_MESH = (2, 2, 1)
PIPELINE_SEQ = 1024
PIPELINE_BATCH = 4
PIPELINE_MICRO = 2
PIPELINE_SA_ITERS = 600
PIPELINE_STAGES = 240
PIPELINE_BF16_ATOL = 0.05
PIPELINE_F32_TOL = 2e-3
# the dp phase: the reference's compressed-DP regression
# (tests/test_compressed_dp.py) on one rank
DP_STEPS = 60
DP_BATCH = 64
DP_LR = 0.05
# the cells phase: the cell bundles (launch.steps) on a one-rank NCCL
# mesh against the eager route, full width and depth, seeded weights
CELLS_MESH = (1, 1)
CELLS_SERVE = ("smollm-135m", "mamba2-370m")
CELLS_PREFILL = (4096, 4)              # (prompt length, batch)
CELLS_DECODE_STEPS = 16
CELLS_TRAIN_ARCH = "smollm-135m"
CELLS_TRAIN = (1024, 4)                # (seq, batch)
CELLS_TRAIN_STEPS = 12
CELLS_TRAIN_RTOL = 1e-5
# the dryrun phase: launch.dryrun on the host's CPU in a subprocess (a
# fake 256-rank group), started before the cells phase and read after it
DRYRUN_RUNS = (("smollm-135m", "train_4k,prefill_32k,decode_32k"),
               ("mamba2-370m", "long_500k"))
DRYRUN_TIMEOUT = 420


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, device: bool = True) -> float:
    """Mean milliseconds per call on the card, after warm-up.  With
    ``device`` the stream first runs a sleep kernel (``SLEEP_CYCLES``, a
    few ms) while the host queues every call, so the events bracket the
    calls' device work and not the host's pace of launching them; without
    it the calls run as the host issues them."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device:
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bounds(flops: float, nbytes: float) -> dict:
    """The least ms the card could take at the f32 FMA peak and what bounds
    it there, and the least ms at the 3xTF32 rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_3xtf32_ms": max(flops / PEAK_3XTF32_FLOPS, t_bytes) * 1e3}


def bf16_bounds(kernel: str, shape: dict) -> dict:
    """The least ms the card could take for a bf16 launch: its FLOPs at the
    dense bf16 tensor-core peak against its bytes at the HBM rate, inputs
    at 2 bytes an element (GEMM and flash outputs too; the SSD kernel's
    outputs are f32, 4 bytes)."""
    from repro_torch.realize.measure import launch_cost
    flops, f32_bytes = launch_cost(kernel, shape)
    if kernel == "ssd_chunk_dual":
        BC, Q, H, P, N = (shape[k] for k in ("BC", "Q", "H", "P", "N"))
        out = BC * (Q * H * P + H * N * P)
        nbytes = 2 * (f32_bytes / 4 - out) + 4 * out
    else:
        nbytes = f32_bytes / 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def mixed_bounds(shape: dict) -> dict:
    """The least ms the card could take for a launch of the SSD chunk
    kernel's mixed instance (x and cum f32, B and C bf16, f32 outputs):
    C Bᵀ at the dense bf16 tensor-core peak and W x and (d .* B)ᵀ x at the
    f32 FMA peak (``bound_ms``) or the 3xTF32 rate (``bound_3xtf32_ms``),
    against the bytes at the HBM rate (B and C 2 bytes an element, the
    rest 4), each read or written once."""
    from repro_torch.realize.measure import attention_pairs
    BC, Q, H, P, N = (shape[k] for k in ("BC", "Q", "H", "P", "N"))
    T = attention_pairs(Q, Q, True)
    scores = 2.0 * BC * T * N / PEAK_BF16_FLOPS
    rest = 2.0 * BC * (T * H * P + Q * H * N * P)
    t_bytes = BC * (4 * (2 * Q * H * P + Q * H + H * N * P)
                    + 2 * 2 * Q * N) / PEAK_HBM_BYTES_S
    t_ops = scores + rest / PEAK_F32_FLOPS
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_3xtf32_ms": max(scores + rest / PEAK_3XTF32_FLOPS,
                                   t_bytes) * 1e3}


def ssd_inputs(randn, BC, Q, H, P, N, dtype: str = "f32",
               offset: bool = False):
    """x, cum (a decreasing cumsum within each chunk), B and C of the SSD
    chunk kernel on the card from ``randn`` (f32): all f32, all bf16, or
    ``"mixed"`` (x and cum f32, B and C bf16, as the model's bf16 compute
    hands them); with ``offset`` x is a view one float into its storage
    (f32 x only)."""
    import torch
    x = on_card(randn, (BC, Q, H, P), offset)
    cum = torch.cumsum(-randn(BC, Q, H).abs() * 0.1, dim=1)
    Bm, Cm = randn(BC, Q, N), randn(BC, Q, N)
    if dtype == "bf16":
        x, cum = x.bfloat16(), cum.bfloat16()
    if dtype in ("bf16", "mixed"):
        Bm, Cm = Bm.bfloat16(), Cm.bfloat16()
    return x, cum, Bm, Cm


def on_card(randn, shape, offset: bool):
    """randn of ``shape``, contiguous; with ``offset`` a view one float into
    its storage (data pointer 4- but not 16-byte aligned)."""
    n = 1
    for d in shape:
        n *= d
    return randn(n + int(offset))[int(offset):].view(*shape)


def sync_matmul(a, b):
    """a @ b through the GEMM's mma.sync kernel (``tiled_matmul_sync_f32``:
    the parent's f32 route, which the TF32 wgmma kernel replaced on aligned
    operands), not counted."""
    import torch

    from repro_torch.kernels import _build
    out = torch.empty((a.shape[0], b.shape[1]), device=a.device)
    code = _build.load("tiled_matmul").tiled_matmul_sync_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[1],
        a.shape[1], a.device.index or 0,
        torch.cuda.current_stream(a.device).cuda_stream)
    if code:
        raise RuntimeError(f"tiled_matmul_sync_f32: CUDA error {code}")
    return out


def sync_flash(q, k, v, causal: bool, q_offset: int = 0):
    """Flash attention through the mma.sync kernel
    (``flash_attention_sync_f32``: the parent's f32 route), not counted."""
    import torch

    from repro_torch.kernels import _build
    out = torch.empty_like(q)
    B, H, Sq, D = q.shape
    code = _build.load("flash_attention").flash_attention_sync_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq,
        k.shape[2], D, int(causal), q_offset, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if code:
        raise RuntimeError(f"flash_attention_sync_f32: CUDA error {code}")
    return out


def add_parent(line: dict, route: str, run, want, tol: dict) -> bool:
    """The parent kernel's route, error and device time into ``line``
    (``parent_route``, ``parent_max_abs_err``, ``parent_ms``); whether its
    result is within ``tol`` of ``want``."""
    import torch
    got = run()
    torch.cuda.synchronize()
    line["parent_route"] = route
    line["parent_max_abs_err"] = (got - want).abs().max().item()
    line["parent_ms"] = time_ms(run)
    return torch.allclose(got, want, **tol)


def check_kernels(dev):
    """Kernel vs plain version at the path's and at ragged shapes.  Returns
    the timed lines by (kernel, shape), and the inputs, chunk and timed
    line of ``ops.ssd_forward`` at the ``mamba2-370m`` layer's shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, mamba_ssd, ops, ref
    from repro_torch.kernels import tiled_matmul as mm
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.realize.measure import launch_cost

    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    timed = {}
    for path, (M, K, N, offset) in [(True, (*s, False)) for s in MM_PATH] \
            + [(False, s) for s in MM_EDGE]:
        a, b = on_card(randn, (M, K), offset), randn(K, N)
        got, want = tiled_matmul(a, b), ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        line = {"phase": "kernel", "kernel": "tiled_matmul",
                "shape": {"M": M, "K": K, "N": N}, "a_offset": int(offset),
                "route": mm.kernel_route(a, b), "arith": ARITH["tiled_matmul"],
                "main_path": path, **MM_TOL,
                "max_abs_err": (got - want).abs().max().item(),
                "repeat_bit_equal": torch.equal(got, tiled_matmul(a, b))}
        parent_ok = True
        if path:
            line.update(bounds(*launch_cost("tiled_matmul",
                                            {"M": M, "K": K, "N": N})))
            line["ms"] = time_ms(lambda: tiled_matmul(a, b))
            line["host_issued_ms"] = time_ms(lambda: tiled_matmul(a, b),
                                             device=False)
            parent_ok = add_parent(line, mm.kernel_route(a, b, sync=True),
                                   lambda: sync_matmul(a, b), want, MM_TOL)
            line["plain_ms"] = time_ms(lambda: ref.matmul_ref(a, b))
            line["library_ms"] = time_ms(lambda: torch.matmul(a, b))
            timed[("tiled_matmul", (M, K, N))] = line
        emit(line)
        if not torch.allclose(got, want, **MM_TOL) or not parent_ok \
                or not line["repeat_bit_equal"]:
            raise AssertionError(f"tiled_matmul disagrees at {(M, K, N)}, "
                                 f"or with itself, or its parent kernel "
                                 f"does")
    for path, (B, H, Sq, Sk, D, causal, offset) in \
            [(True, (*s, False)) for s in FLASH_PATH] \
            + [(False, s) for s in FLASH_EDGE]:
        q = on_card(randn, (B, H, Sq, D), offset)
        k, v = randn(B, H, Sk, D), randn(B, H, Sk, D)
        got = flash_attention_mha(q, k, v, causal=causal)
        want = ref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        line = {"phase": "kernel", "kernel": "flash_attention_mha",
                "shape": {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D},
                "causal": causal, "q_offset": int(offset),
                "route": flash_attention.kernel_route(q, k, v),
                "arith": ARITH["flash_attention_mha"], "main_path": path,
                **FLASH_TOL, "max_abs_err": (got - want).abs().max().item(),
                "repeat_bit_equal": torch.equal(
                    got, flash_attention_mha(q, k, v, causal=causal))}
        parent_ok = True
        if path:
            shape = {**line["shape"], "causal": int(causal)}
            line.update(bounds(*launch_cost("flash_attention_mha", shape)))
            line["ms"] = time_ms(
                lambda: flash_attention_mha(q, k, v, causal=causal))
            line["host_issued_ms"] = time_ms(
                lambda: flash_attention_mha(q, k, v, causal=causal),
                device=False)
            parent_ok = add_parent(
                line, flash_attention.kernel_route(q, k, v, sync=True),
                lambda: sync_flash(q, k, v, causal), want, FLASH_TOL)
            line["plain_ms"] = time_ms(
                lambda: ref.attention_ref(q, k, v, causal=causal))
            line["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal))
            timed[("flash_attention_mha", tuple(shape.values()))] = line
        emit(line)
        if not torch.allclose(got, want, **FLASH_TOL) or not parent_ok \
                or not line["repeat_bit_equal"]:
            raise AssertionError(
                f"flash_attention_mha disagrees at {(B, H, Sq, Sk, D)}, or "
                f"with itself, or its parent kernel does")
    for path, clock, (BC, Q, H, P, N, offset) in \
            [(True, True, s) for s in SSD_PATH] \
            + [(False, True, s) for s in SSD_SERVE + SSD_WIDE] \
            + [(False, False, s) for s in SSD_EDGE + SSD_WIDE_EDGE]:
        x, cum, Bm, Cm = ssd_inputs(randn, BC, Q, H, P, N, "f32", offset)
        got = ssd_chunk_dual(x, cum, Bm, Cm)
        want = ref.ssd_chunk_ref(x, cum, Bm, Cm)
        torch.cuda.synchronize()
        shape = {"BC": BC, "Q": Q, "H": H, "P": P, "N": N}
        line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                "shape": shape, "x_offset": int(offset),
                "route": mamba_ssd.kernel_route(x, Bm, Cm),
                "heads_per_block": mamba_ssd.heads_per_block(x, Bm),
                "arith": ARITH["ssd_chunk_dual"],
                "main_path": path, **SSD_TOL,
                "max_abs_err": max((g - w).abs().max().item()
                                   for g, w in zip(got, want))}
        if clock:
            line.update(bounds(*launch_cost("ssd_chunk_dual", shape)))
            line["ms"] = time_ms(lambda: ssd_chunk_dual(x, cum, Bm, Cm))
            line["host_issued_ms"] = time_ms(
                lambda: ssd_chunk_dual(x, cum, Bm, Cm), device=False)
            line["plain_ms"] = time_ms(
                lambda: ref.ssd_chunk_ref(x, cum, Bm, Cm))
            line["library_ms"] = None
            line["library"] = "none: no single PyTorch call computes it"
        if path:
            timed[("ssd_chunk_dual", tuple(shape.values()))] = line
        emit(line)
        if not all(torch.allclose(g, w, **SSD_TOL)
                   for g, w in zip(got, want)):
            raise AssertionError(
                f"ssd_chunk_dual disagrees at {(BC, Q, H, P, N)}")
    for path, (B, L, H, P, N, chunk) in zip((False, True), SSD_FORWARD):
        args = (randn(B, L, H, P), randn(B, L, H).abs() * 0.1,
                -randn(H).abs(), randn(B, L, 1, N), randn(B, L, 1, N))
        plain = dict(chunk_dual=ref.ssd_chunk_ref,
                     state_pass=ref.ssd_state_ref)
        got, _ = ops.ssd_forward(*args, chunk=chunk)
        want, _ = ops.ssd_forward(*args, chunk=chunk, **plain)
        torch.cuda.synchronize()
        line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                "via": "ops.ssd_forward", "shape": dict(zip(
                    ("B", "L", "H", "P", "N", "chunk"),
                    (B, L, H, P, N, chunk))),
                "main_path": path, **SSD_FORWARD_TOL,
                "max_abs_err": (got - want).abs().max().item()}
        if path:
            # as the host issues it: the recurrence is host-bound
            line["ms"] = time_ms(lambda: ops.ssd_forward(*args, chunk=chunk),
                                 device=False)
            line["plain_ms"] = time_ms(lambda: ops.ssd_forward(
                *args, chunk=chunk, **plain), device=False)
        emit(line)
        if not torch.allclose(got, want, **SSD_FORWARD_TOL):
            raise AssertionError(
                f"ssd_forward disagrees at {(B, L, H, P, N, chunk)}")
        if path:
            layer = (args, chunk, line)
    for path, shape in [(True, s) for s in STATE_PATH] \
            + [(False, s) for s in STATE_EDGE]:
        for route in STATE_ROUTES:
            per = check_state_pass(randn, *shape, timed=path, route=route)
            if path:
                timed.update({(k, shape[:7]): ln for k, ln in per.items()})
    check_chunked(randn)
    check_flash_offset(randn)
    check_flash_stats(randn, dev)
    return timed, layer


def state_inputs(randn, B, nc, Q, H, P, N, G, init):
    """Inputs of the SSD state pass on the card: y_intra, S, cum (a
    decreasing cumsum within each chunk), C, and an initial state or
    None."""
    import torch
    return (randn(B, nc, Q, H, P), randn(B, nc, H, N, P) * 0.1,
            torch.cumsum(-randn(B, nc, Q, H).abs() * 0.05, dim=2),
            randn(B, nc, Q, G, N), randn(B, H, N, P) if init else None)


def check_state_pass(randn, B, nc, Q, H, P, N, G, init, timed: bool,
                     route=None, main_path="realize") -> dict:
    """One ``ssd_state_pass`` kernel line on ``route`` (None: the route
    the rule picks, through ``ssd_state_pass``; else forced by calling the
    route's wrappers): the pass against its plain version (``STATE_TOL``),
    each launch counted; on the split, each of its two kernels against its
    own plain version too.  With ``timed`` the pass's device time, the
    plain version's, the time as the host issues it and the bounds (f32
    FMA, 3xTF32 and HBM; no library call computes it), and each kernel's
    own.  Returns each launched kernel's numbers by name, for the per-pass
    summary."""
    import torch

    from repro_torch.kernels import ref, ssd_state
    from repro_torch.realize.measure import launch_cost
    args = state_inputs(randn, B, nc, Q, H, P, N, G, init)
    y, S, cum, C, h0 = args
    rule = ssd_state.state_route(B, H, P, N, ssd_state.sm_count(y.device))
    route = route or rule

    def run():
        if route == rule:
            return ssd_state.ssd_state_pass(*args)
        if route == "walk":
            return ssd_state.ssd_state_walk(*args)
        hb, h = ssd_state.ssd_state_scan(S, cum, h0)
        return ssd_state.ssd_state_out(y, hb, cum, C), h

    kernels = ssd_state.ROUTE_KERNELS[route]
    wrappers = {k: getattr(ssd_state, k) for k in STATE_KERNELS}
    n0 = {k: fn.launches for k, fn in wrappers.items()}
    got = run()
    launched = {k: fn.launches - n0[k] for k, fn in wrappers.items()}
    want = ref.ssd_state_ref(*args)
    torch.cuda.synchronize()
    shape = dict(zip(("B", "nc", "Q", "H", "P", "N", "G"),
                     (B, nc, Q, H, P, N, G)), init=int(init))
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    ok = all(torch.allclose(g, w, **STATE_TOL) for g, w in zip(got, want)) \
        and launched == {k: int(k in kernels) for k in wrappers}
    # each kernel of the route with its inputs, plain version and cost
    if route == "walk":
        copies = ssd_state.copy_width(C, S)
        parts = {"ssd_state_walk": (lambda: ssd_state.ssd_state_walk(*args),
                                    lambda: ref.ssd_state_ref(*args), err)}
    else:
        hb, h = ref.ssd_state_scan_ref(S, cum, h0)
        scan = ssd_state.ssd_state_scan(S, cum, h0)
        out = ssd_state.ssd_state_out(y, hb, cum, C)
        want_out = ref.ssd_state_out_ref(y, hb, cum, C)
        torch.cuda.synchronize()
        copies = ssd_state.copy_width(C, scan[0])
        errs = (max((g - w).abs().max().item()
                    for g, w in zip(scan, (hb, h))),
                (out - want_out).abs().max().item())
        ok = ok and all(torch.allclose(g, w, **STATE_TOL)
                        for g, w in zip((*scan, out), (hb, h, want_out)))
        parts = {"ssd_state_scan": (
                     lambda: ssd_state.ssd_state_scan(S, cum, h0),
                     lambda: ref.ssd_state_scan_ref(S, cum, h0), errs[0]),
                 "ssd_state_out": (
                     lambda: ssd_state.ssd_state_out(y, hb, cum, C),
                     lambda: ref.ssd_state_out_ref(y, hb, cum, C), errs[1])}
    line = {"phase": "kernel", "kernel": "ssd_state_pass", "shape": shape,
            "route": f"{route} {copies}", "rule_route": rule,
            "kernels": list(kernels), "launches": launched,
            "arith": ARITH[kernels[-1]],
            "main_path": main_path if timed else False, **STATE_TOL,
            "max_abs_err": err}
    if route == "split":
        line["out_heads"] = ssd_state.out_heads(B * nc, H, G, P,
                                                ssd_state.sm_count(y.device))
    if route == rule and line["route"] != ssd_state.kernel_route(S, C):
        ok = False
    per = {}
    for k, (fn, plain, e) in parts.items():
        per[k] = {"max_abs_err": e, "library_ms": None}
        if timed:
            per[k].update(bounds(*launch_cost(k, shape)), ms=time_ms(fn),
                          plain_ms=time_ms(plain),
                          host_issued_ms=time_ms(fn, device=False))
    if timed and route == "split" and G == 1:
        # the reference's own expression (src/repro/kernels/ops.py:95-97)
        C1 = C[:, :, :, 0]
        per["ssd_state_out"].update(
            library_ms=time_ms(lambda: y + torch.einsum(
                "bcqn,bchnp,bcqh->bcqhp", C1, hb, cum.exp())),
            library="y_intra + torch.einsum('bcqn,bchnp,bcqh->bcqhp', C, "
                    "h_before, exp(cum)): the reference's expression, three "
                    "calls (exp, einsum, add), TF32 off")
    line["per_kernel"] = per
    if timed:
        # the route's bound: its kernels' (the split writes and reads
        # h_before besides); the pass's work done once, as the walk does it
        for b in ("bound_ms", "bound_3xtf32_ms"):
            line[b] = sum(p[b] for p in per.values())
        line["bound_by"] = max(per.values(),
                               key=lambda p: p["bound_ms"])["bound_by"]
        line["bound_pass_ms"] = bounds(
            *launch_cost("ssd_state_pass", shape))["bound_ms"]
        line["ms"] = time_ms(run)
        line["host_issued_ms"] = time_ms(run, device=False)
        line["plain_ms"] = time_ms(lambda: ref.ssd_state_ref(*args))
        line["library_ms"] = None
        line["library"] = "none: no single PyTorch call computes it"
    emit(line)
    if not ok:
        raise AssertionError(f"ssd_state_pass ({line['route']}) disagrees, "
                             f"names another route or launched {launched} "
                             f"at {(B, nc, Q, H, P, N, G, init)}")
    return per


def check_chunked(randn) -> None:
    """The model's chunked SSD (``nn.mamba2.ssd_chunked``) through the
    kernels against its plain version at the config's chunk: one chunk
    kernel launch per group and the state pass's route's kernels once a
    call, within 2e-4."""
    import torch

    from repro_torch.kernels import ssd_state
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.nn.mamba2 import ssd_chunked, ssd_chunked_ref
    wrappers = {"ssd_chunk_dual": ssd_chunk_dual,
                **{k: getattr(ssd_state, k) for k in STATE_KERNELS}}
    for B, L, H, P, G, N, chunk, init in CHUNKED:
        args = (randn(B, L, H, P), randn(B, L, H).abs() * 0.1,
                -randn(H).abs(), randn(B, L, G, N), randn(B, L, G, N))
        h0 = randn(B, H, N, P) if init else None
        n0 = {k: fn.launches for k, fn in wrappers.items()}
        got = ssd_chunked(*args, chunk=chunk, init_state=h0)
        launched = {k: fn.launches - n0[k] for k, fn in wrappers.items()}
        want = ssd_chunked_ref(*args, chunk=chunk, init_state=h0)
        torch.cuda.synchronize()
        route = ssd_state.route_kernels(B, H, P, N, args[0].device)
        expect = {k: G if k == "ssd_chunk_dual" else int(k in route)
                  for k in wrappers}
        ok = all(torch.allclose(g, w, **SSD_FORWARD_TOL)
                 for g, w in zip(got, want))
        emit({"phase": "kernel", "kernel": "ssd_state_pass",
              "via": "nn.mamba2.ssd_chunked",
              "shape": {"B": B, "L": L, "H": H, "P": P, "G": G, "N": N,
                        "chunk": chunk, "init": int(init)},
              "launches": launched, "main_path": False, **SSD_FORWARD_TOL,
              "max_abs_err": max((g - w).abs().max().item()
                                 for g, w in zip(got, want))})
        if not ok or launched != expect:
            raise AssertionError(f"ssd_chunked disagrees or launched "
                                 f"{launched}, not {expect}, at "
                                 f"{(B, L, H, P, G, N, chunk)}")


def check_flash_offset(randn) -> None:
    """Causal flash with ``q_offset = Sk - Sq`` against the plain version
    on the upcast inputs, f32 (2e-5) and bf16 (2e-2)."""
    import torch

    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import flash_attention_mha
    for dtype, tol in ((torch.float32, FLASH_TOL),
                       (torch.bfloat16, FLASH_BF16_TOL)):
        for B, H, Sq, Sk, D in FLASH_OFFSET:
            q, k, v = (randn(B, H, n, D).to(dtype) for n in (Sq, Sk, Sk))
            off = Sk - Sq
            got = flash_attention_mha(q, k, v, causal=True, q_offset=off)
            want = ref.attention_ref(q.float(), k.float(), v.float(),
                                     causal=True, q_offset=off)
            torch.cuda.synchronize()
            emit({"phase": "kernel", "kernel": "flash_attention_mha",
                  "dtype": str(dtype).rsplit(".", 1)[-1],
                  "shape": {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D,
                            "causal": 1, "q_offset": off},
                  "route": flash_attention.kernel_route(q, k, v),
                  "main_path": False, **tol,
                  "max_abs_err": (got.float() - want).abs().max().item()})
            if got.dtype != dtype \
                    or not torch.allclose(got.float(), want, **tol):
                raise AssertionError(f"flash q_offset={off} disagrees at "
                                     f"{(B, H, Sq, Sk, D, dtype)}")


def check_flash_stats(randn, dev) -> None:
    """``flash_attention_mha(return_stats=True)`` against
    ``attention_ref(return_stats=True)`` on the upcast inputs, out, m and l,
    f32 (2e-5) and bf16 (2e-2), one launch each; at Sk = 0 no launch, m =
    -2e38 and l = 0.  Then ``Attention(cache_stack=...)`` on the card
    against ``use_kernels=False`` (f32 compute, ``CACHE_STACK_TOL``): the
    old pages and the new segment through the flash kernel with their
    statistics (no launch for the empty old cache at pos 0), the stacks
    written alike."""
    import torch

    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.nn.attention import Attention
    for dtype, tol in ((torch.float32, FLASH_TOL),
                       (torch.bfloat16, FLASH_BF16_TOL)):
        for B, H, Sq, Sk, D, causal, off in FLASH_STATS + [
                (1, 2, 70, 0, 64, False, 0)]:
            q, k, v = (randn(B, H, n, D).to(dtype) for n in (Sq, Sk, Sk))
            n0 = flash_attention_mha.launches
            got = flash_attention_mha(q, k, v, causal=causal, q_offset=off,
                                      return_stats=True)
            launched = flash_attention_mha.launches - n0
            want = ref.attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal, q_offset=off,
                                     return_stats=True)
            torch.cuda.synchronize()
            errs = [(g.float() - w).abs().max().item() if Sk else 0.0
                    for g, w in zip(got, want)]
            emit({"phase": "kernel", "kernel": "flash_attention_mha",
                  "via": "return_stats",
                  "dtype": str(dtype).rsplit(".", 1)[-1],
                  "shape": {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D,
                            "causal": int(causal), "q_offset": off},
                  "route": flash_attention.kernel_route(q, k, v) if Sk
                  else "no launch (Sk = 0)", "launches": launched,
                  "main_path": False, **tol,
                  "max_abs_err": dict(zip(("out", "m", "l"), errs)),
                  "m_min": got[1].min().item(), "l_max": got[2].max().item()})
            ok = all(torch.allclose(g.float(), w, **tol)
                     for g, w in zip(got, want)) \
                and launched == int(Sk > 0) \
                and got[1].dtype == got[2].dtype == torch.float32
            if not Sk:
                ok = ok and bool((got[1] == -2.0e38).all()) \
                    and bool((got[2] == 0).all())
            if not ok:
                raise AssertionError(f"flash statistics disagree at "
                                     f"{(B, H, Sq, Sk, D, causal, off)}")
    B, d, H, KV, hd, smax, li = 2, 256, 4, 2, 64, 2048, 1
    for pos, S in CACHE_STACK:
        mod = Attention(d, H, KV, hd, device=dev,
                        gen=torch.Generator(device=dev).manual_seed(pos))
        x = randn(B, S, d)
        positions = (pos + torch.arange(S, device=dev))[None]
        stacks = [randn(3, B, smax, KV, hd) for _ in range(2)]
        got = {}
        for use_kernels in (True, False):
            tk, tv = (t.clone() for t in stacks)
            n0 = flash_attention_mha.launches
            y, _ = mod(x, positions=positions, cache_stack=(tk, tv, li, pos),
                       compute_dtype=torch.float32, use_kernels=use_kernels)
            torch.cuda.synchronize()
            got[use_kernels] = (y, tk, tv,
                                flash_attention_mha.launches - n0)
        (y, tk, tv, n), (yp, tkp, tvp, npl) = got[True], got[False]
        err = ((y - yp).abs().max() / yp.abs().max()).item()
        emit({"phase": "kernel", "kernel": "flash_attention_mha",
              "via": "nn.attention cache_stack",
              "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": hd,
                        "pos": pos, "max_seq": smax},
              "launches": n, "plain_launches": npl, "main_path": False,
              "rel_tol": CACHE_STACK_TOL, "max_rel_err": err})
        if err > CACHE_STACK_TOL or n != (1 if pos == 0 else 2) or npl \
                or not (torch.equal(tk, tkp) and torch.equal(tv, tvp)):
            raise AssertionError(f"cache_stack at pos {pos}: {err}, "
                                 f"{n} launches")


def check_bf16(dev) -> dict:
    """Each kernel with bf16 operands at every shape of the paths and at
    ragged sizes, against its plain version on the upcast inputs.  Each
    shape is launched twice (the count must move by two): the first
    output must have the reference's output type (bf16 for GEMM and flash,
    f32 for SSD), and GEMM's and flash's second the first's bits.  The
    path shapes also get the kernel's time, the plain version's and the
    bf16 library call's (``torch.matmul``, ``scaled_dot_product_attention``
    on bf16; none for SSD), and the bound at bf16 rates.  Returns the timed
    lines by (kernel, shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, mamba_ssd, ref
    from repro_torch.kernels import tiled_matmul as mm
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(*s, device=dev,
                                   generator=gen).bfloat16()
    timed = {}

    def run(fn, kernel, *args, **kw):
        """Two launches on the same inputs, each counted: the first's
        output, and whether the second gave the same bits."""
        n0 = fn.launches
        out, again = fn(*args, **kw), fn(*args, **kw)
        torch.cuda.synchronize()
        if fn.launches != n0 + 2:
            raise AssertionError(f"{kernel} bf16: the launches were not "
                                 f"counted ({n0} -> {fn.launches})")
        pairs = zip(out, again) if isinstance(out, tuple) else [(out, again)]
        return out, all(torch.equal(a, b) for a, b in pairs)

    def finish(line, kernel, key, path, err, ok, timings, clock=False):
        """``path``: timed and kept for the per-pass summary; ``clock``:
        timed only.  GEMM and flash must also repeat their bits."""
        line["max_abs_err"] = err
        ok = ok and line["repeat_bit_equal"]
        if path or clock:
            line.update(mixed_bounds(line["shape"])
                        if line["dtype"] == "mixed"
                        else bf16_bounds(kernel, line["shape"]))
            line.update({k: time_ms(f, device=k != "host_issued_ms")
                         if f else None for k, f in timings.items()})
        if path:
            timed[(kernel, key)] = line
        emit(line)
        if not ok:
            raise AssertionError(f"{kernel} bf16 disagrees at {key}")

    for path, (M, K, N) in [(True, s) for s in MM_PATH] \
            + [(False, s) for s in MM_BF16_EDGE]:
        a, b = randn(M, K), randn(K, N)
        got, same = run(tiled_matmul, "tiled_matmul", a, b)
        want = ref.matmul_ref(a.float(), b.float())
        line = {"phase": "kernel", "kernel": "tiled_matmul", "dtype": "bf16",
                "shape": {"M": M, "K": K, "N": N},
                "route": mm.kernel_route(a, b),
                "arith": ARITH_BF16["tiled_matmul"], "main_path": path,
                "out_dtype": str(got.dtype), "repeat_bit_equal": same,
                **MM_BF16_TOL}
        finish(line, "tiled_matmul", (M, K, N), path,
               (got.float() - want).abs().max().item(),
               got.dtype == torch.bfloat16
               and torch.allclose(got.float(), want, **MM_BF16_TOL),
               {"ms": lambda: tiled_matmul(a, b),
                "plain_ms": lambda: ref.matmul_ref(a, b),
                "library_ms": lambda: torch.matmul(a, b)})
    for path, (B, H, Sq, Sk, D, causal) in \
            [(True, s) for s in FLASH_PATH] \
            + [(False, s) for s in FLASH_BF16_EDGE]:
        q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D)
        got, same = run(flash_attention_mha, "flash_attention_mha", q, k, v,
                        causal=causal)
        want = ref.attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
        shape = {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D,
                 "causal": int(causal)}
        line = {"phase": "kernel", "kernel": "flash_attention_mha",
                "dtype": "bf16", "shape": shape,
                "route": flash_attention.kernel_route(q, k, v),
                "arith": ARITH_BF16["flash_attention_mha"],
                "main_path": path, "out_dtype": str(got.dtype),
                "repeat_bit_equal": same, **FLASH_BF16_TOL}
        finish(line, "flash_attention_mha", tuple(shape.values()), path,
               (got.float() - want).abs().max().item(),
               got.dtype == torch.bfloat16
               and torch.allclose(got.float(), want, **FLASH_BF16_TOL),
               {"ms": lambda: flash_attention_mha(q, k, v, causal=causal),
                "plain_ms": lambda: ref.attention_ref(q, k, v,
                                                      causal=causal),
                "library_ms": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)})
    randn32 = lambda *s: torch.randn(*s, device=dev, generator=gen)
    ssd_bf16 = [(True, True, "bf16", (*s[:5], False)) for s in SSD_PATH] \
        + [(False, True, "bf16", (*s[:5], False))
           for s in SSD_SERVE + SSD_WIDE[:1]] \
        + [(False, False, "bf16", (*s, False)) for s in SSD_BF16_EDGE]
    # the mixed instance, which the serve paths launch, at the serve shapes
    # and the realization's, then ragged
    ssd_mixed = [(False, True, "mixed", s)
                 for s in SSD_SERVE + SSD_WIDE[:1] + SSD_PATH] \
        + [(False, False, "mixed", s) for s in SSD_MIXED_EDGE]
    for path, clock, dtype, (BC, Q, H, P, N, offset) in ssd_bf16 + ssd_mixed:
        x, cum, Bm, Cm = ssd_inputs(randn32, BC, Q, H, P, N, dtype, offset)
        got, same = run(ssd_chunk_dual, "ssd_chunk_dual", x, cum, Bm, Cm)
        want = ref.ssd_chunk_ref(x.float(), cum.float(), Bm.float(),
                                 Cm.float())
        shape = {"BC": BC, "Q": Q, "H": H, "P": P, "N": N}
        line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                "dtype": dtype, "shape": shape, "x_offset": int(offset),
                "route": mamba_ssd.kernel_route(x, Bm, Cm),
                "heads_per_block": mamba_ssd.heads_per_block(x, Bm),
                "arith": ARITH_BF16["ssd_chunk_dual"] if dtype == "bf16"
                else ARITH_MIXED, "main_path": path,
                "out_dtype": str(got[0].dtype), "repeat_bit_equal": same,
                **SSD_BF16_TOL}
        if clock:
            line["library"] = "none: no single PyTorch call computes it"
        finish(line, "ssd_chunk_dual", tuple(shape.values()), path,
               max((g - w).abs().max().item() for g, w in zip(got, want)),
               all(g.dtype == torch.float32
                   and torch.allclose(g, w, **SSD_BF16_TOL)
                   for g, w in zip(got, want)),
               {"ms": lambda: ssd_chunk_dual(x, cum, Bm, Cm),
                "host_issued_ms": lambda: ssd_chunk_dual(x, cum, Bm, Cm),
                "plain_ms": lambda: ref.ssd_chunk_ref(x, cum, Bm, Cm),
                "library_ms": None}, clock=clock)
    return timed


def profile_ssd_forward(args, chunk: int, timed_line: dict) -> dict:
    """One ``ops.ssd_forward`` call under ``torch.profiler``: the device
    time of all its kernels and copies; the device's idle share over the
    call's wall as the host issues it without the profiler (``ms`` of the
    timed line); the profiled wall (ended by a synchronize), which the
    profiler stretches; and the kernel launches and their device time in
    three groups, by kernel name: the chunk kernel, the state pass (the
    inter-chunk recurrence and output: one walk, or the split's two
    kernels, by the route the rule takes at the layer's shape,
    ``state_route``) and the rest of the eager glue (discretization, cumsum,
    casts, pads).  The chrome trace goes to ``results/``.  It runs last:
    launches that follow a profiler session in the same process were
    slower (the ``mamba2-370m`` pass took 205-249 ms after it against
    124-147 ms without; NVIDIA H100 80GB HBM3, 700 W)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops, ssd_state
    ops.ssd_forward(*args, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ops.ssd_forward(*args, chunk=chunk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    REPORTS.mkdir(parents=True, exist_ok=True)
    trace = REPORTS / "chip_smoke.ssd_forward.trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events
              if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    line = {"phase": "profile", "via": "ops.ssd_forward",
            "shape": timed_line["shape"], "gated": False,
            "trace": str(trace.relative_to(ROOT)),
            "host_issued_ms": timed_line["ms"], "profiled_wall_ms": wall_ms,
            "device_ms": sum(e["dur"] for e in kernels + copies) / 1e3}
    line["idle_share"] = 1.0 - line["device_ms"] / line["host_issued_ms"]
    groups = {"chunk_kernel": [], "state_pass": [], "glue": []}
    for e in kernels:
        name = e.get("name", "")
        key = ("chunk_kernel" if "ssd_chunk" in name else
               "state_pass" if "ssd_state_" in name else "glue")
        groups[key].append(e)
    line["split"] = {k: {"launches": len(v),
                         "device_ms": sum(e["dur"] for e in v) / 1e3}
                     for k, v in groups.items()}
    line["recurrence_launches"] = len(groups["state_pass"])
    x, _, _, Bm, _ = args
    B, _, H, P = x.shape
    line["state_route"] = ssd_state.state_route(
        B, H, P, Bm.shape[-1], ssd_state.sm_count(x.device))
    line["state_kernels"] = sorted({re.search(r"ssd_state_\w+",
                                              e["name"]).group(0)
                                    for e in groups["state_pass"]})
    names = {}
    for e in groups["glue"]:
        short = e["name"][:60]
        names[short] = names.get(short, 0) + 1
    line["glue_kernels"] = dict(sorted(names.items(),
                                       key=lambda kv: -kv[1])[:8])
    return line


def stage_cube_errors(g, plan, dev) -> dict:
    """Largest difference, relative to the cube's max, of every stage cube
    between the kernel route and the plain route, each stage given the
    same inputs (the kernel route's upstream cubes and the same drawn
    sources and weights); and the kernel route's program."""
    import torch

    from repro_torch.realize.program import (build_program,
                                             draw_stage_arrays,
                                             stage_args_from_numpy)
    kern = build_program(g, plan, device=dev, use_kernels=True)
    plain = build_program(g, plan, device=dev, use_kernels=False)
    args = stage_args_from_numpy(draw_stage_arrays(kern, 0), kern.device)
    outputs = {}
    worst, worst_cube, n_cubes = 0.0, None, 0
    for sk, sp, own in zip(kern.stages, plain.stages, args):
        ext = [outputs[n] for n in sk.ext_inputs]
        got, want = sk.fn(*ext, *own), sp.fn(*ext, *own)
        for name, a, b in zip(sk.out_layers, got, want):
            if tuple(a.shape) != tuple(b.shape) \
                    or not torch.isfinite(a).all():
                raise AssertionError(f"stage cube {name}: shape or finite")
            err = ((a - b).abs().max() / b.abs().max().clamp_min(1e-9)).item()
            n_cubes += 1
            if err > worst:
                worst, worst_cube = err, name
            outputs[name] = a
    torch.cuda.synchronize()
    return {"stage_cubes_checked": n_cubes, "stage_max_rel_err": worst,
            "stage_worst_cube": worst_cube,
            "stage_rel_tol": STAGE_REL_TOL}, kern


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, by kernel name (each counts its launches)."""
    from repro_torch.kernels import ssd_state
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    return {"tiled_matmul": tiled_matmul,
            "flash_attention_mha": flash_attention_mha,
            "ssd_chunk_dual": ssd_chunk_dual,
            **{k: getattr(ssd_state, k) for k in STATE_KERNELS}}


def run_path(path, dev):
    """Realize one path's fixture through the CLI entry point with
    ``--calibrate``; count the launches of the measured pass.  Check the
    predicted side (totals against the pinned ones, every stage that
    launches a kernel predicted, every ratio finite) and the overlay, and
    that an identity overlay returns its input Tech.  Returns the launches
    and the kernel route's program."""
    import math

    from repro_torch.core.workloads import make_workload
    from repro_torch.launch.realize import main as realize_main
    from repro_torch.realize.calibrate import TechOverlay, load_overlay
    from repro_torch.realize.plan import load_realize_candidates, plans_for

    (name, fixture, binding, n_stages, want_launches, want_flops,
     want_pred) = path
    fixture = FIXTURES / fixture
    report = REPORTS / f"chip_smoke.{name}.jsonl"
    overlay_path = REPORTS / f"chip_smoke.{name}.overlay.json"
    argv = ["--ckpt", str(fixture), "--workload", binding, "--top", "1",
            "--device", "cuda", "--out", str(report), "--force",
            "--calibrate", "--overlay-out", str(overlay_path)]
    last_record = lambda: [json.loads(line) for line
                           in report.read_text().splitlines()
                           if '"_key"' in line][-1]
    wrappers = kernel_wrappers()
    with contextlib.redirect_stdout(sys.stderr):   # the CLI's own table
        realize_main(argv)                          # warm-up pass
        predict_s_first = last_record()["predict_s"]
        for fn in wrappers.values():
            fn.launches = 0
        for k in WGMMA_F32:
            wrappers[k].wgmma_f32_launches = 0
        t0 = time.perf_counter()
        realize_main(argv)                          # the counted pass
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    wgmma = {k: wrappers[k].wgmma_f32_launches for k in WGMMA_F32}
    rec = last_record()
    stages = rec["stages"]
    if len(stages) != n_stages or launches != want_launches:
        raise AssertionError(f"path {name} ran {len(stages)} stages with "
                             f"launches {launches}")
    if any(wgmma[k] != launches[k] for k in WGMMA_F32):
        raise AssertionError(f"path {name}: of its f32 launches {launches} "
                             f"only {wgmma} took the TF32 wgmma kernels")
    no_args = [s["index"] for s in stages if not s["arg_bytes"] > 0]
    if no_args:
        raise AssertionError(f"path {name}: stages {no_args} record no "
                             f"argument bytes")
    # a dense path counts integer FLOPs exactly; a scaled one multiplies
    # them by host float64 factors, held like the predicted totals
    flops_tol = 0.0 if isinstance(want_flops, int) else PRED_REL_TOL
    if not math.isclose(rec["totals"]["flops"], want_flops,
                        rel_tol=flops_tol):
        raise AssertionError(f"path {name} counted "
                             f"{rec['totals']['flops']} FLOPs, not "
                             f"{want_flops}")
    pred = {k: rec["totals"][k] for k in want_pred}
    for k, v in want_pred.items():
        if not math.isclose(pred[k], v, rel_tol=PRED_REL_TOL):
            raise AssertionError(f"path {name} predicted {k} = {pred[k]}, "
                                 f"not {v}")
    unpredicted = [s["index"] for s in stages
                   if s["flops"] > 0 and s["pred_flops"] <= 0]
    ratios = [v for s in stages for v in s["ratios"].values()] \
        + list(rec["ratio_summary"].values())
    if unpredicted or not all(math.isfinite(v) and v > 0 for v in ratios):
        raise AssertionError(f"path {name}: stages {unpredicted} launch a "
                             f"kernel with pred_flops 0, or a ratio is not "
                             f"finite: {rec['ratio_summary']}")
    overlay = load_overlay(overlay_path)
    wl_name, spec = binding.split("=", 1)
    g = make_workload(spec)
    (cand, plan), = plans_for(load_realize_candidates(fixture, {wl_name: g},
                                                      verbose=False))
    identity = TechOverlay()
    if identity.apply(cand.arch.tech) is not cand.arch.tech \
            or identity.apply_arch(cand.arch) is not cand.arch \
            or overlay.n_stages != n_stages:
        raise AssertionError(f"path {name}: the identity overlay changed "
                             f"the Tech, or the overlay saw "
                             f"{overlay.n_stages} stages")
    cubes, prog = stage_cube_errors(g, plan, dev)
    planned = {k: 0 for k in wrappers}
    for sp in prog.stages:
        for k, _ in sp.kernel_launches:
            planned[k] += 1
    if launches != planned:
        raise AssertionError(f"path {name} launched {launches}, its plan "
                             f"declares {planned}")
    scales = [s["expected_scale"] for s in stages if s.get("expected_scale")]
    if g.is_scaled != bool(scales) or (scales and len(scales) != n_stages):
        raise AssertionError(f"path {name}: {len(scales)} stages carry "
                             f"expected_scale, the graph is_scaled="
                             f"{g.is_scaled}")
    extra = {} if not scales else {"expected_scale": {
        k: {"min": min(e[k] for e in scales), "max": max(e[k] for e in scales)}
        for k in scales[0]}}
    emit({"phase": "path", "workload": name, "arch": rec["arch"],
          "batch_unit": rec["batch_unit"], "stages": len(stages),
          "seconds": seconds, "launches": launches,
          "wgmma_f32_launches": wgmma,
          "arg_bytes": sum(s["arg_bytes"] for s in stages),
          "temp_bytes": sum(s["temp_bytes"] for s in stages),
          "wall_ms": rec["totals"]["wall_s"] * 1e3,
          "flops": rec["totals"]["flops"],
          "dci_bytes": rec["totals"]["dci_bytes"],
          "hbm_bytes": rec["totals"]["hbm_bytes"], **pred,
          "ratio_summary": rec["ratio_summary"],
          "overlay": overlay.to_dict(),
          "identity_overlay_returns_input_tech": True,
          "predict_s": rec["predict_s"],
          "predict_s_first_pass": predict_s_first,
          "per_stage": [[s["index"], s["wall_s"] * 1e3, s["flops"],
                         s["dci_bytes"], s["pred_flops"],
                         s["pred_d2d_bytes"], s["arg_bytes"],
                         s["temp_bytes"]] for s in stages],
          "per_stage_columns": ["stage", "wall_ms", "flops", "dci_bytes",
                                "pred_flops", "pred_d2d_bytes", "arg_bytes",
                                "temp_bytes"],
          **extra, **cubes})
    if cubes["stage_max_rel_err"] > STAGE_REL_TOL:
        raise AssertionError(f"stage cube {cubes['stage_worst_cube']} "
                             f"differs by {cubes['stage_max_rel_err']}")
    return launches, prog


def loop_config():
    from repro_torch.core.dse import DSEConfig
    from repro_torch.core.sa import SAConfig
    return DSEConfig(batch=4, sa=SAConfig(iters=200, seed=0),
                     keep_mappings=True)


def check_fixture_dse() -> dict:
    """The port's DSE writes the committed ``tf-paper`` fixture again:
    header equal, the one record's arch, seed, workload and mapping equal,
    energy and delay within rel 1e-9 (the bound the CPU tests hold the
    reference's fresh DSE to)."""
    import math

    from repro_torch.core.dse import run_dse
    from repro_torch.core.explore import ResumableSweep
    from repro_torch.core.hw import simba_arch
    from repro_torch.core.workloads import make_workload
    name, spec = LOOP_WORKLOAD
    fixture = FIXTURES / "tf-paper.simba.ckpt.jsonl"
    ck = REPORTS / "chip_smoke.loop.fixture.ckpt.jsonl"
    ck.unlink(missing_ok=True)
    t0 = time.perf_counter()
    run_dse([simba_arch()], {name: make_workload(spec)}, loop_config(),
            checkpoint=ck)
    seconds = time.perf_counter() - t0
    header = lambda p: json.loads(Path(p).read_text().splitlines()[0])
    fresh = ResumableSweep.read(ck).as_dict()
    fixed = ResumableSweep.read(fixture).as_dict()
    if header(ck) != header(fixture) or fresh.keys() != fixed.keys() \
            or len(fixed) != 1:
        raise AssertionError(f"the port's DSE wrote {header(ck)} with keys "
                             f"{list(fresh)}, not the fixture's")
    (key, want), = fixed.items()
    got = fresh[key]
    same = {f: got[f] == want[f]
            for f in ("arch", "seed", "workload", "mapping")}
    rel = {f: abs(got[f] - want[f]) / abs(want[f])
           for f in ("energy_j", "delay_s")}
    if not all(same.values()) or not all(
            math.isclose(got[f], want[f], rel_tol=1e-9) for f in rel):
        raise AssertionError(f"the port's DSE record differs from the "
                             f"fixture's: {same}, {rel}")
    return {"header": header(ck)["_config"], "equal": same, "rel_err": rel,
            "byte_identical": ck.read_bytes() == fixture.read_bytes(),
            "seconds": seconds}


def run_loop(dev, timed: dict):
    """The ``loop`` phase: the port's DSE writes the fixture again, then
    ``close_loop`` on the five candidates with the launch counts set to 0
    just before it; the screened sweep; the gates.  Returns the line and
    each realized candidate's (launches, kernel route program)."""
    import collections
    import math

    from repro_torch.core import hw
    from repro_torch.core.dse import run_dse
    from repro_torch.core.explore import candidate_key
    from repro_torch.core.workloads import make_workload
    from repro_torch.examples.realize_demo import close_loop

    t_phase = time.perf_counter()
    REPORTS.mkdir(parents=True, exist_ok=True)
    fixture = check_fixture_dse()
    name, spec = LOOP_WORKLOAD
    workloads = {name: make_workload(spec)}
    cands = [getattr(hw, preset)().replace(**kw)
             for preset, kw in LOOP_CANDIDATES]
    cfg = loop_config()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    with contextlib.redirect_stdout(sys.stderr):    # the demo's own lines
        res = close_loop(workloads, cands, cfg, device=dev, top=LOOP_TOP,
                         ckpt=REPORTS / "chip_smoke.loop.ckpt.jsonl",
                         out=REPORTS / "chip_smoke.loop.realize.jsonl")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    t0 = time.perf_counter()
    screened = run_dse(cands, workloads, cfg, screen_keep=LOOP_SCREEN_KEEP)
    screen_s = time.perf_counter() - t0
    base = {candidate_key(p.arch): p for p in res.baseline}
    if not screened or any(p.objective != base[candidate_key(p.arch)].objective
                           for p in screened):
        raise AssertionError("the screened sweep scored a survivor "
                             "differently from the exhaustive sweep")
    summed = collections.Counter()
    realized, runs = [], {}
    for rank, r in enumerate(res.realized, 1):
        rep, prog = r.report, r.program
        plan_launches = collections.Counter(
            {k: 0 for k in wrappers})
        plan_launches.update(k for sp in prog.stages
                             for k, _ in sp.kernel_launches)
        summed.update(r.launches)
        stages = [s.to_record() for s in rep.stages]
        unpredicted = [s["index"] for s in stages
                       if s["flops"] > 0 and s["pred_flops"] <= 0]
        ratios = [v for s in stages for v in s["ratios"].values()] \
            + list(rep.ratio_summary().values())
        if r.launches != dict(plan_launches) or unpredicted \
                or not all(math.isfinite(v) and v > 0 for v in ratios):
            raise AssertionError(
                f"loop candidate {rep.arch_label}: launched {r.launches}, "
                f"the plan has {dict(plan_launches)}; stages {unpredicted} "
                f"unpredicted; ratios {rep.ratio_summary()}")
        untimed = {(k, tuple(s.values())) for sp in prog.stages
                   for k, s in sp.launches} - set(timed)
        if untimed:
            raise AssertionError(f"loop candidate {rep.arch_label} launches "
                                 f"at shapes no kernel line timed: {untimed}")
        cubes, _ = stage_cube_errors(prog.graph, prog.plan, dev)
        if cubes["stage_max_rel_err"] > STAGE_REL_TOL:
            raise AssertionError(f"loop candidate {rep.arch_label}: stage "
                                 f"cube {cubes['stage_worst_cube']} differs "
                                 f"by {cubes['stage_max_rel_err']}")
        realized.append({
            "rank": rank, "arch": rep.arch_label,
            "key": candidate_key(r.candidate.arch),
            "batch_unit": rep.batch_unit, "stages": len(rep.stages),
            "launches": r.launches, "wall_ms": rep.totals()["wall_s"] * 1e3,
            "seconds": r.seconds, "predict_s": rep.predict_s,
            "ratio_summary": rep.ratio_summary(), **cubes})
        runs[f"loop#{rank}"] = (r.launches, prog)
    if dict(summed) != launches:
        raise AssertionError(f"the loop launched {launches}, its realized "
                             f"passes {dict(summed)}")
    if [p.objective for p in res.identity] \
            != [p.objective for p in res.baseline]:
        raise AssertionError("the identity pass is not the baseline")
    line = {
        "phase": "loop", "workload": spec, "fixture": fixture,
        "dse_s": {"exhaustive": res.dse_s["baseline"], "screened": screen_s,
                  "identity": res.dse_s["identity"],
                  "calibrated": res.dse_s["calibrated"]},
        "dse_s_clock": "host seconds on the machine that holds the card",
        "candidates": [{"arch": p.arch.label(), "key": candidate_key(p.arch),
                        "objective": p.objective, "mc": p.mc,
                        "energy_j": p.energy_j, "delay_s": p.delay_s}
                       for p in res.baseline],
        "winner": res.baseline[0].arch.label(),
        "screened": {"screen_keep": LOOP_SCREEN_KEEP,
                     "survivors": [candidate_key(p.arch) for p in screened],
                     "equal_to_exhaustive": True},
        "launches": launches, "realized": realized,
        "overlay": res.overlay.to_dict(),
        "identity_bit_identical": True,
        "calibrated": [{"key": k, "baseline": b, "calibrated": c}
                       for k, (b, c) in res.rows.items()],
        "ranking_changed": res.ranking_changed,
        "seconds": time.perf_counter() - t_phase}
    return line, runs


# ---------------------------------------------------------------------------
# realize_mesh: each plan stage on a sub-mesh of four ranks sharing the card
# ---------------------------------------------------------------------------

def mesh_archs():
    """The two 2 x 2-core archs of the mesh phase's DSE (the CPU tests'
    ``_keep_ckpt``)."""
    from repro_torch.core.hw import ArchConfig
    return [ArchConfig(x_cores=2, y_cores=2, xcut=xcut, ycut=1, noc_bw=32.0,
                       d2d_bw=16.0, dram_bw=64.0, glb_kb=512,
                       macs_per_core=1024) for xcut in (1, 2)]


def mesh_check_rank(ck: str, out: str) -> None:
    """One rank of the mesh phase's check (``launch.mesh.start_local_ranks``
    runs it in each of ``MESH_RANKS`` processes): the checkpoint's
    ``MESH_TOP`` best records and the hand-built plans in mesh mode through
    the kernels, every launch count set to 0 just before each pass and read
    just after, against the plan's launches for this rank; rank 0 also runs
    each in logical mode on the same seed and compares every gathered
    stage cube and the DCI bytes.  Rank 0 writes the results to ``out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.bridge import plan_from_tuples
    from repro_torch.core.workloads import make_workload
    from repro_torch.launch import mesh as lmesh
    from repro_torch.realize.plan import (hand_plans, load_realize_candidates,
                                          plans_for)
    from repro_torch.realize.program import build_program

    rank = dist.get_rank()
    wrappers = kernel_wrappers()
    name, spec = MESH_WORKLOAD
    g = make_workload(spec)
    cases = [(c.arch.label(), g, plan) for c, plan in plans_for(
        load_realize_candidates(Path(ck), {name: g}, top=MESH_TOP,
                                verbose=False), MESH_RANKS)]
    cases += [(n, *plan_from_tuples(*hand_plans(MESH_RANKS)[n]))
              for n in MESH_HAND_PLANS]
    res = {"transport": lmesh.transport(lmesh.rank_device("cuda")),
           "cases": {}}
    for label, graph, plan in cases:
        prog = build_program(graph, plan, device="cuda", mesh=range(
            MESH_RANKS))
        for fn in wrappers.values():
            fn.launches = 0
        run = prog.execute(seed=0)
        torch.cuda.synchronize()
        mine = {"counted": {k: fn.launches for k, fn in wrappers.items()},
                "declared": [(k, list(s.values())) for sp in prog.stages
                             if sp.pos is not None
                             for k, s in sp.launches_at(sp.pos)]}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        if rank:
            continue
        logical = build_program(graph, plan, device="cuda").execute(seed=0)
        worst, worst_cube = 0.0, None
        for cube, want in logical["outputs"].items():
            got = run["outputs"][cube]
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"realize_mesh {label}: cube {cube} "
                                     f"shape or finite")
            err = ((got - want).abs().max()
                   / want.abs().max().clamp_min(1e-9)).item()
            if err >= worst:
                worst, worst_cube = err, cube
        per_stage = []
        for sp in prog.stages:
            kinds = collections.Counter(k for pos in range(sp.n_devices)
                                        for k, _ in sp.launches_at(pos))
            per_stage.append(dict(kinds))
        res["cases"][label] = {
            "stages": len(prog.stages), "ranks": ranks,
            "dci_bytes": run["dci_bytes"],
            "logical_dci_bytes": logical["dci_bytes"],
            "ici_bytes": run["ici_bytes"],
            "coll_by_kind": run["coll_by_kind"],
            "wall_ms": [w * 1e3 for w in run["wall_s"]],
            "launches_per_stage": per_stage,
            "stage_cubes_checked": len(logical["outputs"]),
            "stage_max_rel_err": worst, "stage_worst_cube": worst_cube}
    if rank == 0:
        Path(out).write_text(json.dumps(res))


def run_realize_mesh(dev) -> tuple:
    """The ``realize_mesh`` phase.  The port's DSE writes a keep_mappings
    checkpoint (``mesh_archs()``, ``tf-paper`` at Table I width, batch 4,
    SA ``MESH_SA_ITERS`` iterations, seed 0, numpy); ``python -m
    repro_torch.launch.realize --mesh 4 --host-ranks 4 --top 2
    --calibrate`` realizes its two best records, four processes sharing the
    card over gloo; then ``mesh_check_rank`` on four ranks.  Gates: every
    rank exits 0; each stage cube, gathered, within ``STAGE_REL_TOL`` of the
    logical route's on the same seed; the DCI bytes the logical route's
    (and the report's); each rank's launches the plan's for that rank;
    ``ici_bytes`` > 0 on some stage; ``f_noc`` fitted (not 1.0) where a
    stage has ICI and NoC bytes.  Returns the line and each rank's
    (launches, launch keys) over the check's passes."""
    import tempfile

    from repro_torch.core.dse import DSEConfig, run_dse
    from repro_torch.core.sa import SAConfig
    from repro_torch.core.workloads import make_workload
    from repro_torch.launch.mesh import start_local_ranks
    from repro_torch.realize.calibrate import load_overlay

    t_phase = time.perf_counter()
    REPORTS.mkdir(parents=True, exist_ok=True)
    name, spec = MESH_WORKLOAD
    with tempfile.TemporaryDirectory(dir=REPORTS) as tmp:
        tmp = Path(tmp)
        ck = tmp / "mesh.ckpt.jsonl"
        t0 = time.perf_counter()
        run_dse(mesh_archs(), {name: make_workload(spec)},
                DSEConfig(batch=4, sa=SAConfig(iters=MESH_SA_ITERS, seed=0),
                          keep_mappings=True), checkpoint=ck)
        dse_s = time.perf_counter() - t0
        report = tmp / "mesh.realize.jsonl"
        argv = [sys.executable, "-m", "repro_torch.launch.realize",
                "--ckpt", str(ck), "--workload", f"{name}={spec}",
                "--mesh", str(MESH_RANKS), "--host-ranks", str(MESH_RANKS),
                "--top", str(MESH_TOP), "--calibrate", "--out", str(report)]
        t0 = time.perf_counter()
        cli = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                             timeout=MESH_TIMEOUT,
                             env={**os.environ, "PYTHONPATH": str(SRC)})
        cli_s = time.perf_counter() - t0
        print(cli.stdout, file=sys.stderr)
        if cli.returncode != 0:
            raise AssertionError(f"realize_mesh: the CLI exited "
                                 f"{cli.returncode}: {cli.stderr[-3000:]}")
        lines = report.read_text().splitlines()
        header = json.loads(lines[0])["_config"]
        recs = [json.loads(line) for line in lines[1:]]
        overlay = load_overlay(report.with_suffix(".overlay.json"))
        t0 = time.perf_counter()
        start_local_ranks(MESH_RANKS, mesh_check_rank,
                          (str(ck), str(tmp / "check.json")),
                          device_type="cuda")
        check_s = time.perf_counter() - t0
        check = json.loads((tmp / "check.json").read_text())
    faults = []
    if len(recs) != MESH_TOP or f":pool={MESH_RANKS}:" not in header:
        faults.append(f"{len(recs)} records under {header}")
    cases = check["cases"]
    for label, case in cases.items():
        if case["stage_max_rel_err"] > STAGE_REL_TOL:
            faults.append(f"{label}: cube {case['stage_worst_cube']} differs "
                          f"by {case['stage_max_rel_err']}")
        if case["dci_bytes"] != case["logical_dci_bytes"]:
            faults.append(f"{label}: DCI {case['dci_bytes']} against the "
                          f"logical {case['logical_dci_bytes']}")
        for r, got in enumerate(case["ranks"]):
            want = collections.Counter(k for k, _ in got["declared"])
            if {k: v for k, v in got["counted"].items() if v} != dict(want):
                faults.append(f"{label}: rank {r} launched "
                              f"{got['counted']}, its part {dict(want)}")
    candidates = []
    for rec in recs:
        case = cases.get(rec["arch"])
        if case is None or [s["dci_bytes"] for s in rec["stages"]] \
                != case["logical_dci_bytes"]:
            faults.append(f"report {rec['arch']}: DCI differs from the "
                          f"logical route's")
            continue
        candidates.append({
            "arch": rec["arch"], "batch_unit": rec["batch_unit"],
            "stages": [[s["index"], s["n_devices"], s["ici_bytes"],
                        s["pred_noc_bytes"], s["coll_by_kind"],
                        s["wall_s"] * 1e3, launches]
                       for s, launches in zip(rec["stages"],
                                              case["launches_per_stage"])],
            "wall_ms": rec["totals"]["wall_s"] * 1e3,
            "ici_bytes": rec["totals"]["ici_bytes"],
            "pred_noc_bytes": rec["totals"]["pred_noc_bytes"],
            "dci_bytes": rec["totals"]["dci_bytes"],
            "ratio_summary": rec["ratio_summary"],
            "stage_max_rel_err": case["stage_max_rel_err"],
            "stage_cubes_checked": case["stage_cubes_checked"]})
    evidence = any(s["ici_bytes"] > 0 and s["pred_noc_bytes"] > 0
                   for rec in recs for s in rec["stages"])
    if not any(s["ici_bytes"] > 0 for rec in recs for s in rec["stages"]):
        faults.append("no stage measured ICI bytes")
    if evidence and overlay.f_noc == 1.0:
        faults.append("f_noc was not fitted")
    hand = {label: {k: case[k] for k in (
        "stages", "ici_bytes", "coll_by_kind", "dci_bytes", "wall_ms",
        "launches_per_stage", "stage_max_rel_err", "stage_cubes_checked")}
        for label, case in cases.items() if label in MESH_HAND_PLANS}
    runs = {}
    for r in range(MESH_RANKS):
        counted = collections.Counter()
        keys = []
        for case in cases.values():
            counted.update(case["ranks"][r]["counted"])
            keys += [(k, tuple(s)) for k, s in case["ranks"][r]["declared"]]
        runs[f"realize_mesh:r{r}"] = ({k: counted[k]
                                       for k in kernel_wrappers()}, keys)
    line = {"phase": "realize_mesh", "workload": spec, "ranks": MESH_RANKS,
            "archs": [a.label() for a in mesh_archs()],
            "sa_iters": MESH_SA_ITERS, "fingerprint": header,
            "transport": check["transport"],
            "stage_columns": ["stage", "n_devices", "ici_bytes",
                              "pred_noc_bytes", "coll_by_kind", "wall_ms",
                              "launches (summed over the ranks)"],
            "candidates": candidates, "hand_plans": hand,
            "overlay": overlay.to_dict(),
            "per_rank_launches": {p: v[0] for p, v in runs.items()},
            "dse_s": dse_s, "cli_s": cli_s, "check_s": check_s,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if faults:
        raise AssertionError("realize_mesh: " + "; ".join(faults))
    return line, runs


def mesh_kernel_lines(dev, keys, main_path: str = "realize_mesh") -> dict:
    """f32 kernel lines at the launch shapes the mesh phase's ranks ran
    (GEMM, flash with the rank's query offset, the SSD chunk kernel, the
    state pass), each against its plain version on the same inputs, with
    its device time, the plain version's, the library call's (SDPA with
    the causal mask the offset gives) and the bounds.  Returns them by
    launch key."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, mamba_ssd, ref
    from repro_torch.kernels import tiled_matmul as mm
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.realize.measure import launch_cost

    gen = torch.Generator(device=dev).manual_seed(4)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    timed = {}
    for key in sorted(set(keys), key=repr):
        kernel, shp = key
        if key in timed:
            continue
        if kernel == "tiled_matmul":
            M, K, N = shp
            a, b = randn(M, K), randn(K, N)
            got, want = tiled_matmul(a, b), ref.matmul_ref(a, b)
            torch.cuda.synchronize()
            shape = {"M": M, "K": K, "N": N}
            line = {"phase": "kernel", "kernel": kernel, "shape": shape,
                    "route": mm.kernel_route(a, b),
                    "arith": ARITH[kernel], "main_path": main_path,
                    **MM_TOL, "max_abs_err": (got - want).abs().max().item(),
                    **bounds(*launch_cost(kernel, shape))}
            run = lambda: tiled_matmul(a, b)
            plain = lambda: ref.matmul_ref(a, b)
            library = lambda: torch.matmul(a, b)
            ok = torch.allclose(got, want, **MM_TOL) and add_parent(
                line, mm.kernel_route(a, b, sync=True),
                lambda: sync_matmul(a, b), want, MM_TOL)
        elif kernel == "flash_attention_mha":
            shape = dict(zip(("B", "H", "Sq", "Sk", "D", "causal",
                              "q_offset"), shp))
            B, H, Sq, Sk, D = (shape[k] for k in ("B", "H", "Sq", "Sk", "D"))
            causal, off = bool(shape["causal"]), shape.get("q_offset", 0)
            q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), \
                randn(B, H, Sk, D)
            got = flash_attention_mha(q, k, v, causal=causal, q_offset=off)
            want = ref.attention_ref(q, k, v, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            mask = (off + torch.arange(Sq, device=dev)[:, None]
                    >= torch.arange(Sk, device=dev)[None, :])
            line = {"phase": "kernel", "kernel": kernel, "shape": shape,
                    "route": flash_attention.kernel_route(q, k, v),
                    "arith": ARITH[kernel], "main_path": main_path,
                    **FLASH_TOL,
                    "max_abs_err": (got - want).abs().max().item(),
                    **bounds(*launch_cost(kernel, shape))}
            run = lambda: flash_attention_mha(q, k, v, causal=causal,
                                              q_offset=off)
            plain = lambda: ref.attention_ref(q, k, v, causal=causal,
                                              q_offset=off)
            library = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask if causal else None)
            ok = torch.allclose(got, want, **FLASH_TOL) and add_parent(
                line, flash_attention.kernel_route(q, k, v, sync=True),
                lambda: sync_flash(q, k, v, causal, off), want, FLASH_TOL)
        elif kernel == "ssd_chunk_dual":
            shape = dict(zip(("BC", "Q", "H", "P", "N"), shp))
            x, cum, Bm, Cm = ssd_inputs(randn, *shp)
            got = ssd_chunk_dual(x, cum, Bm, Cm)
            want = ref.ssd_chunk_ref(x, cum, Bm, Cm)
            torch.cuda.synchronize()
            line = {"phase": "kernel", "kernel": kernel, "shape": shape,
                    "route": mamba_ssd.kernel_route(x, Bm, Cm),
                    "heads_per_block": mamba_ssd.heads_per_block(x, Bm),
                    "arith": ARITH[kernel], "main_path": main_path,
                    **SSD_TOL, "max_abs_err": max(
                        (g - w).abs().max().item()
                        for g, w in zip(got, want)),
                    **bounds(*launch_cost(kernel, shape))}
            run = lambda: ssd_chunk_dual(x, cum, Bm, Cm)
            plain = lambda: ref.ssd_chunk_ref(x, cum, Bm, Cm)
            library = None
            ok = all(torch.allclose(g, w, **SSD_TOL)
                     for g, w in zip(got, want))
        elif kernel in STATE_KERNELS:
            for k, line in check_state_pass(randn, *shp, False, timed=True,
                                            main_path=main_path).items():
                timed[(k, shp)] = line
            continue
        else:
            raise AssertionError(f"realize_mesh launched {kernel}")
        line["ms"] = time_ms(run)
        line["host_issued_ms"] = time_ms(run, device=False)
        line["plain_ms"] = time_ms(plain)
        line["library_ms"] = None if library is None else time_ms(library)
        if library is None:
            line["library"] = "none: no single PyTorch call computes it"
        emit(line)
        if not ok:
            raise AssertionError(f"{kernel} disagrees at {shape} "
                                 f"({main_path})")
        timed[key] = line
    return timed


KERNEL_FILES = {
    "tiled_matmul": ("src/repro_torch/kernels/csrc/tiled_matmul.cu",
                     "src/repro/kernels/tiled_matmul.py:51"),
    "flash_attention_mha": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:90"),
    "ssd_chunk_dual": ("src/repro_torch/kernels/csrc/mamba_ssd.cu",
                       "src/repro/kernels/mamba_ssd.py:48"),
    **{k: ("src/repro_torch/kernels/csrc/ssd_state.cu",
           "src/repro/kernels/ops.py:51") for k in STATE_KERNELS},
}


def program_keys(prog) -> list:
    """The (kernel, shape) of every launch of one pass of a realized
    program: its plan's launches, the state pass's kernels included."""
    return [(kernel, tuple(shape.values())) for sp in prog.stages
            for kernel, shape in sp.kernel_launches]


def per_pass_summary(timed: dict, timed_bf16: dict, runs: dict) -> list:
    """Each kernel's numbers summed over one pass of each path, of each
    realized loop candidate and of each serve phase (the timed line of
    every launch's shape, once per launch; the serve phases' flash
    launches are bf16, as they run them), and each one's share apart;
    under ``bf16`` the realization passes' launches again with bf16
    operands (they run f32).  ``runs`` maps a path, loop candidate or serve
    phase to its (launches, [(kernel, shape) of each launch])."""
    out = []
    for name, (source, replaces) in KERNEL_FILES.items():
        per_path, lines, lines16 = {}, [], []
        for path, (launches, keys) in runs.items():
            ls = [timed[k] for k in keys if k[0] == name]
            if len(ls) != launches[name]:
                raise AssertionError(f"{path}: {launches[name]} {name} "
                                     f"launches, {len(ls)} in its plan")
            lib = [ln["library_ms"] for ln in ls]
            per_path[path] = {
                "launches": launches[name],
                "ms": sum(ln["ms"] for ln in ls),
                "plain_ms": sum(ln["plain_ms"] for ln in ls),
                "bound_ms": sum(ln["bound_ms"] for ln in ls),
                "bound_3xtf32_ms": sum(ln["bound_3xtf32_ms"] for ln in ls),
                "library_ms": None if None in lib else sum(lib)}
            if name in WGMMA_F32 and ls:
                per_path[path]["routes"] = dict(collections.Counter(
                    ln["route"] for ln in ls))
                parent = [ln.get("parent_ms") for ln in ls]
                if None not in parent:
                    per_path[path]["parent_ms"] = sum(parent)
            lines += ls
            lines16 += [timed_bf16[k] for k in keys
                        if k[0] == name and k in timed_bf16]
        total = lambda k: sum(p[k] for p in per_path.values())
        lib = [ln["library_ms"] for ln in lines]
        line = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total("launches"),
            "max_abs_err": max(ln["max_abs_err"] for ln in lines),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(lines, key=lambda ln: ln["bound_ms"])["bound_by"],
            "bound_3xtf32_ms": total("bound_3xtf32_ms"), "arith": ARITH[name],
            "library_ms": None if None in lib else sum(lib),
            "per": "one pass of each path, of each realized loop candidate "
                   "and of each serve phase, summed; per_path splits it",
            "per_path": per_path}
        if None in lib:
            line["library"] = "none: no single PyTorch call computes it"
        if name in WGMMA_F32:
            line["functions"] = function_lines(name, lines)
        if lines16:
            lib16 = [ln["library_ms"] for ln in lines16]
            line["bf16"] = {
                "route": "cuda", "dtype": "bf16",
                "routes": sorted({ln["route"] for ln in lines16}),
                "arith": ARITH_BF16[name],
                "max_abs_err": max(ln["max_abs_err"] for ln in lines16),
                "ms": sum(ln["ms"] for ln in lines16),
                "plain_ms": sum(ln["plain_ms"] for ln in lines16),
                "bound_ms": sum(ln["bound_ms"] for ln in lines16),
                "bound_by": max(lines16,
                                key=lambda ln: ln["bound_ms"])["bound_by"],
                "library_ms": None if None in lib16 else sum(lib16),
                "per": "the launches of one pass of each realization path "
                       "and loop candidate, at their shapes, with bf16 "
                       "operands (not run on the paths)"}
        out.append(line)
    return out


# the kernel function a route of the GEMM and flash launches: f32 on the
# TF32 wgmma kernels ("... wgmma tma tf32x3") or on the mma.sync kernels
# they replaced on aligned operands; bf16 on the bf16 kernels (the GEMM's
# ragged bf16 on its mma.sync kernel)
ROUTE_FUNCTIONS = {
    "tiled_matmul": (("wgmma tma tf32x3", "gemm_wgmma_tf32x3"),
                     ("wgmma tma bf16", "gemm_wgmma_bf16"),
                     ("", "gemm_3xtf32")),
    "flash_attention_mha": (("wgmma tma tf32x3", "flash_fwd_wgmma_tf32x3"),
                            ("bf16", "flash_fwd_bf16"), ("", "flash_fwd"))}


def function_lines(name: str, lines: list) -> list:
    """The per-pass launches of the GEMM or flash (``lines``: one timed
    line a launch) split by the kernel function each took
    (``ROUTE_FUNCTIONS``): launches, routes, the sums of ms, the parent
    (mma.sync) kernel's ms on the same inputs where timed, plain, bounds
    and library ms, the largest error."""
    out = {}
    for ln in lines:
        fn = next(f for end, f in ROUTE_FUNCTIONS[name]
                  if ln["route"].endswith(end))
        out.setdefault(fn, []).append(ln)
    summed = []
    for fn, ls in out.items():
        total = lambda k: (None if any(ln.get(k) is None for ln in ls)
                           else sum(ln[k] for ln in ls))
        summed.append({
            "name": fn, "route": "cuda", "launches": len(ls),
            "routes": dict(collections.Counter(ln["route"] for ln in ls)),
            "max_abs_err": max(ln["max_abs_err"] for ln in ls),
            "ms": total("ms"), "parent_ms": total("parent_ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_3xtf32_ms": total("bound_3xtf32_ms"),
            "library_ms": total("library_ms")})
    return summed


def cost_wrappers() -> dict:
    """The cost model's kernel wrappers, by kernel name."""
    from repro_torch.kernels.fused_eval import fused_eval, segment_replay
    return {"fused_eval": fused_eval, "segment_replay": segment_replay}


def sweep_arch():
    """The widest candidate of ``sweep:fused``'s grid: 70 cores on two
    chiplets (a row of 952 cells with ``tf-paper``)."""
    from repro_torch.core.dse import grid_candidates
    return grid_candidates(**SWEEP_FUSED_SPEC["grid"])[2]


def cost_layouts() -> list:
    """(name, arch, graph, total batch) of the cost kernels' lines: the
    reference's fused-pass test arch (4x3 cores, two chiplets) with
    ``moe-quick`` and S-Arch with the granite graph of the fused phase, at
    the fused phase's batch; and ``sweep:fused``'s rows, ``tf-paper`` on
    :func:`sweep_arch` at the sweep's batch."""
    from repro_torch.core.hw import ArchConfig, simba_arch
    from repro_torch.core.workloads import make_workload
    return [("zoo:moe-quick", ArchConfig(**ZOO_ARCH),
             make_workload("moe-quick"), FUSED_TOTAL_BATCH),
            ("granite", simba_arch(), make_workload(FUSED_SPEC),
             FUSED_TOTAL_BATCH),
            ("sweep:tf-paper", sweep_arch(),
             make_workload(SWEEP_FUSED_SPEC["workloads"]["tf"]),
             SWEEP_FUSED_SPEC["cfg"]["batch"])]


def cost_requests(arch, g, n: int, seed: int,
                  total_batch: int = FUSED_TOTAL_BATCH) -> list:
    """``n`` (group, random LMS) requests over the graph's partition, as a
    lockstep iteration or a screen hands them to the evaluator."""
    import numpy as np

    from repro_torch.core.encoding import random_lms
    from repro_torch.core.graph_partition import partition_graph
    rng = np.random.default_rng(seed)
    groups = partition_graph(g, arch, total_batch)
    return [(grp, random_lms(grp, g, arch.n_cores, arch.n_dram, rng))
            for grp in (groups[int(i)]
                        for i in rng.integers(len(groups), size=n))]


def _bound(flops: float, peak: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_bytes": nbytes, "bound_ops": flops}


def cell_counts(x) -> dict:
    """How the fused inputs ``x`` crowd onto cells: the most entries one
    cell takes in a row, as a count and as a share of that row, and the
    mean over the warps' loads (32 consecutive entries of a row) of the
    most entries that go to one cell, the adds one atomic instruction
    would serialize without warp aggregation."""
    import numpy as np
    most, share, warp = 0, 0.0, []
    for lo, hi in zip(x.off[:-1], x.off[1:]):
        row = x.idx[lo:hi]
        if row.size:
            top = int(np.bincount(row).max())
            most, share = max(most, top), max(share, top / row.size)
            warp += [int(np.bincount(row[i:i + 32]).max())
                     for i in range(0, row.size, 32)]
    return {"max_cell_entries": most, "max_cell_share": share,
            "warp_same_cell_mean": float(np.mean(warp)) if warp else 0.0}


def check_cost_kernels(dev) -> dict:
    """``fused_eval`` and ``segment_replay`` at the batch sizes of a
    lockstep SA iteration and of a screen, on the three layouts of
    :func:`cost_layouts`.  ``fused_eval``
    is held against its plain version on the same inputs on the card and
    against the exact numpy engine (rel 1e-4, equal bottleneck), called
    on the batch's tensors and through the evaluator's fused route, which
    launches it on views of the plan's packed buffers
    (``max_rel_err_path_vs_plain``, ``max_rel_err_vs_exact``);
    ``segment_replay`` (at ``REPLAY_B``: the lockstep batch, a screen and
    more rows than SMs) against ``np.bincount`` on the same stream
    (rtol 2e-4 / atol 1e-2, and bit for bit: each cell's entries are added
    in stream order), ``REPLAY_REPS`` launches on the same inputs giving
    one distinct result.  Each line has the
    kernel's device time, the plain version's, the kernel's as the host
    issues it, the library call's (``index_add_`` for the replay; no
    PyTorch call computes the fused pass), the bound (the stream read
    once, the outputs written once, at the HBM rate) and the host time of
    one whole batch evaluation each way (``eval_batch_ms``: numpy against
    fused, streams and caches warm).  A ``fused_eval`` line also has its
    stream's real length (no pads), the bound the parent version's padded
    stream would have had (``parent_bound_ms``: the stream padded to a
    power of two), the block size, the copies of the row a block sums
    into, the parts a row is split into (1: one launch) and the dynamic
    shared memory of its launch, and ``launch_floor_ms``: the device time of one empty kernel
    (``torch.cuda._sleep(0)``: one block of one thread), timed the same
    way.  Returns the lines by (kernel, layout, B)."""
    import torch

    from repro_torch.core.evaluator import Evaluator
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.fused_eval import copies as fe_copies
    from repro_torch.kernels.fused_eval import fused_eval
    from repro_torch.kernels.fused_eval import splits as fe_splits

    names = ("compute", "noc", "d2d", "dram")
    threads = int(re.search(r"constexpr int kThreads = (\d+);", (
        _build.CSRC / "fused_eval.cu").read_text()).group(1))
    floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    timed = {}
    for layout, arch, g, batch in cost_layouts():
        for B in FUSED_B:
            reqs = cost_requests(arch, g, B, seed=B, total_batch=batch)
            ev = Evaluator(arch, g, fused_device=dev)
            exact = ev.eval_requests_batch(reqs, batch)
            path = ev.eval_requests_batch(reqs, batch, backend="fused")
            plan = ev.fused_plan()
            host = ev._fused_inputs(reqs, batch)
            args = [torch.from_numpy(a.copy()).to(dev) for a in host]
            kw = dict(spans=plan.spans, d2d_mask=plan.d2d_mask,
                      consts=plan.consts, has_d2d=plan.has_d2d,
                      buf_len=plan.buf_len)
            out, bn = fused_eval(plan, *args)
            want, wbn = ref.fused_eval_ref(*args, **kw)
            torch.cuda.synchronize()
            scale = want.abs().clamp_min(1e-30)
            rel_plain = ((out - want).abs() / scale).max().item()
            # the main path's route: evaluate_rows on the packed buffers
            rows = torch.tensor(
                [[ge.delay_s, ge.energy_j, ge.stage_time_s,
                  ge.glb_overflow_bytes, *ge.energy_breakdown.values()]
                 for ge, _ in path], dtype=torch.float64).T
            rel_path = ((rows - want.double().cpu()).abs()
                        / scale.double().cpu()).max().item()
            rel_exact = max(
                abs(getattr(gf, f) - getattr(ge, f)) / abs(getattr(ge, f))
                for (ge, _), (gf, _) in zip(exact, path)
                for f in ("delay_s", "energy_j", "stage_time_s"))
            wbn_host = wbn.cpu().tolist()
            same_bn = all(gf.bottleneck == ge.bottleneck
                          == names[wbn_host[b]]
                          for b, ((ge, _), (gf, _)) in enumerate(zip(exact,
                                                                     path)))
            n = int(host.idx.size)
            n_pad = 1 << max(4, (max(n, 1) - 1).bit_length())
            hot = cell_counts(host)
            outputs = out.numel() * 4 + B * 4
            nbytes = sum(a.nbytes for a in host) + outputs
            line = {"phase": "kernel", "kernel": "fused_eval",
                    "layout": layout, "arch": arch.label(),
                    "total_batch": batch, "B": B,
                    "buf_len": plan.buf_len, "stream": n,
                    "main_path": (layout, B) == ("granite", FUSED_CHAINS),
                    "rel_tol": FUSED_REL_TOL,
                    "max_abs_err": (out - want).abs().max().item(),
                    "max_rel_err_vs_plain": rel_plain,
                    "max_rel_err_path_vs_plain": rel_path,
                    "max_rel_err_vs_exact": rel_exact,
                    "bottleneck_equal": same_bn,
                    **_bound(n + 2 * B * plan.buf_len, PEAK_F32_FLOPS,
                             nbytes),
                    "parent_stream": n_pad,
                    "parent_bound_ms": _bound(
                        n_pad + 2 * B * plan.buf_len, PEAK_F32_FLOPS,
                        8 * n_pad + 12 * B + outputs)["bound_ms"],
                    "threads": threads,
                    "copies": fe_copies(plan.device, plan.buf_len),
                    "splits": fe_splits(plan.device, plan.buf_len),
                    "smem_bytes": 4 * plan.buf_len
                    * fe_copies(plan.device, plan.buf_len),
                    **hot,
                    "ms": time_ms(lambda: fused_eval(plan, *args)),
                    "launch_floor_ms": floor_ms,
                    "host_issued_ms": time_ms(lambda: fused_eval(plan, *args),
                                              device=False),
                    "plain_ms": time_ms(
                        lambda: ref.fused_eval_ref(*args, **kw)),
                    "library_ms": None,
                    "library": "none: no single PyTorch call computes it"}
            line["eval_batch_ms"] = {
                be: host_ms(lambda: ev.eval_requests_batch(
                    reqs, batch, backend=be))
                for be in ("numpy", "fused")}
            timed[("fused_eval", layout, B)] = line
            emit(line)
            if not (rel_plain <= FUSED_REL_TOL and torch.equal(bn, wbn)
                    and rel_path <= FUSED_REL_TOL
                    and rel_exact <= FUSED_REL_TOL and same_bn):
                raise AssertionError(f"fused_eval disagrees at {layout} "
                                     f"B={B}: {rel_plain}, {rel_path}, "
                                     f"{rel_exact}, bottleneck {same_bn}")

        for B in REPLAY_B:
            line = replay_line(dev, layout, arch, g, batch, B)
            line["cells_per_block"] = _build.load(
                "fused_eval").replay_cells_per_block(line["cells"], 0)
            timed[("segment_replay", layout, B)] = line
            emit(line)
            if not (line["within_tol"] and line["distinct"] == 1
                    and line["bit_equal_bincount"]):
                raise AssertionError(f"segment_replay disagrees or is not "
                                     f"reproducible at {layout} B={B}: "
                                     f"{line['distinct']} distinct results")
    return timed


def replay_line(dev, layout, arch, g, batch, B) -> dict:
    """``segment_replay`` on the analyzer's replay stream of ``B`` requests
    (:func:`cost_requests`, seed ``B``) at one layout of
    :func:`cost_layouts`: ``REPLAY_REPS`` launches on the same inputs and
    their distinct results, the first held to ``np.bincount`` on the same
    stream (``REPLAY_TOL``, and bit for bit), the kernel's device time, as
    the host issues it, the plain version's, ``index_add_``'s and the
    bound.  Gates nothing: :func:`check_cost_kernels` gates the line, and
    ``benchmarks/port_segment_replay.py`` prints it for any tree."""
    import numpy as np
    import torch

    from repro_torch.core.evaluator import Evaluator
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_eval import segment_replay

    reqs = cost_requests(arch, g, B, seed=B, total_batch=batch)
    ev = Evaluator(arch, g, fused_device=dev)
    idx, vals, _ = ev.analyzer._request_streams(reqs, batch)
    n_cells = B * ev.analyzer._buf_len
    ti, tv = torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev)
    outs = torch.stack([segment_replay(ti, tv, n_cells)
                        for _ in range(REPLAY_REPS)])
    distinct = torch.unique(outs, dim=0).shape[0]
    got = outs[0].cpu().numpy()
    del outs
    want = np.bincount(idx, weights=vals, minlength=n_cells)
    diff = np.abs(got - want)
    return {"phase": "kernel", "kernel": "segment_replay",
            "layout": layout, "arch": arch.label(), "B": B,
            "cells": n_cells, "stream": int(idx.size),
            "main_path": (layout, B) == ("granite", FUSED_B[1]),
            **REPLAY_TOL, "max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / np.maximum(
                np.abs(want), 1e-300))[want != 0].max()),
            "within_tol": bool(np.allclose(got, want, **REPLAY_TOL)),
            "reps": REPLAY_REPS, "distinct": distinct,
            "bit_equal_bincount": bool(np.array_equal(got, want)),
            **_bound(idx.size, PEAK_F64_FLOPS,
                     idx.nbytes + vals.nbytes + n_cells * 8),
            "ms": time_ms(lambda: segment_replay(ti, tv, n_cells)),
            "host_issued_ms": time_ms(
                lambda: segment_replay(ti, tv, n_cells), device=False),
            "plain_ms": time_ms(
                lambda: ref.segment_replay_ref(ti, tv, n_cells)),
            "library_ms": time_ms(
                lambda: torch.zeros(n_cells, dtype=tv.dtype,
                                    device=dev).index_add_(0, ti, tv)),
            "library": "torch.Tensor.index_add_"}

def host_ms(fn, reps: int = 5) -> float:
    """Mean host milliseconds of ``fn`` after one warm-up call (``fn``
    returns host values, so its device work has ended)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run_fused(dev) -> dict:
    """The ``fused`` phase: replica-exchange SA on the granite graph
    (S-Arch), once on the exact numpy engine and once scoring proposals
    with the fused pass on the card (``SAConfig(backend="fused")``), with
    the cost kernels' counts set to 0 just before; proposals a second each
    way (every request the lockstep hands the evaluator); each winner
    re-evaluated by an independent exact evaluator, which must give the
    reported cost, energy and delay to the bit.  Then the analyzer replay
    on the card: ``analyze_requests(backend="fused")`` of a screen-sized
    batch against the exact replay (rtol 2e-4 / atol 1e-2, and bit for
    bit since the replay adds in stream order).  Fails unless
    both kernels launched, ``fused_eval`` once an iteration (an iteration
    whose proposals are all cached launches none: 198-200 of 200)."""
    import numpy as np

    from repro_torch.core.evaluator import CachedEvaluator, Evaluator
    from repro_torch.core.explore import replica_exchange_sa
    from repro_torch.core.graph_partition import partition_graph
    from repro_torch.core.hw import simba_arch
    from repro_torch.core.sa import SAConfig
    from repro_torch.core.workloads import make_workload

    class Counting(CachedEvaluator):
        proposals = 0

        def eval_groups_batched(self, requests, total_batch,
                                backend="numpy"):
            self.proposals += len(requests)
            return super().eval_groups_batched(requests, total_batch,
                                               backend=backend)

    t_phase = time.perf_counter()
    g, arch = make_workload(FUSED_SPEC), simba_arch()
    groups = partition_graph(g, arch, FUSED_TOTAL_BATCH)
    wrappers = cost_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    sa_lines = {}
    for backend in ("numpy", "fused"):
        cfg = SAConfig(iters=FUSED_ITERS, seed=0, n_chains=FUSED_CHAINS,
                       backend=backend)
        ev = Counting(arch, g, fused_device=dev)
        t0 = time.perf_counter()
        res = replica_exchange_sa(g, arch, groups, FUSED_TOTAL_BATCH, cfg,
                                  evaluator=ev)
        secs = time.perf_counter() - t0
        final = Evaluator(arch, g).evaluate(res.mapping, FUSED_TOTAL_BATCH)
        equal = (res.cost == final.cost(cfg.beta, cfg.gamma)
                 and res.energy_j == final.energy_j
                 and res.delay_s == final.delay_s)
        sa_lines[backend] = {
            "seconds": secs, "proposals": ev.proposals,
            "proposals_per_s": ev.proposals / secs, "cost": res.cost,
            "energy_j": res.energy_j, "delay_s": res.delay_s,
            "winner_equals_exact": equal}
        if not equal:
            raise AssertionError(f"fused phase, backend {backend}: the "
                                 f"reported cost {res.cost} is not the "
                                 f"exact re-evaluation's")
    an = Evaluator(arch, g, fused_device=dev).analyzer
    reqs = cost_requests(arch, g, FUSED_B[1], seed=7)
    exact = an.analyze_requests(reqs, FUSED_TOTAL_BATCH)
    fused = an.analyze_requests(reqs, FUSED_TOTAL_BATCH, backend="fused")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    diff = np.abs(fused.buf - exact.buf)
    replay = {"B": FUSED_B[1], **REPLAY_TOL,
              "max_abs_err": float(diff.max()),
              "bit_equal": bool(np.array_equal(fused.buf, exact.buf)),
              "weight_totals_equal": bool(np.array_equal(
                  fused.weight_totals, exact.weight_totals))}
    if not (np.allclose(fused.buf, exact.buf, **REPLAY_TOL)
            and replay["bit_equal"] and replay["weight_totals_equal"]):
        raise AssertionError(f"fused replay disagrees: {replay}")
    if not (all(launches.values()) and FUSED_ITERS - 2
            <= launches["fused_eval"] <= FUSED_ITERS):
        raise AssertionError(f"the fused phase launched {launches}")
    return {"phase": "fused", "workload": FUSED_SPEC, "arch": arch.label(),
            "groups": len(groups), "chains": FUSED_CHAINS,
            "iters": FUSED_ITERS, "total_batch": FUSED_TOTAL_BATCH,
            **sa_lines,
            "fused_over_numpy_s": sa_lines["fused"]["seconds"]
            / sa_lines["numpy"]["seconds"],
            "same_winner_cost": sa_lines["fused"]["cost"]
            == sa_lines["numpy"]["cost"],
            "replay": replay, "launches": launches,
            "clock": "host seconds on the machine that holds the card",
            "seconds": time.perf_counter() - t_phase}


def run_sweep() -> tuple:
    """The ``sweep`` phase: ``sweep:quick`` then ``sweep:fused`` (the
    constants above), through ``repro_torch.launch.sweep_ctl``'s ``launch``
    in this process.  Gates: every quick fault kind exits 0 and prints
    ``verify-clean: OK``; each winner of the clean fused run, re-evaluated
    by an independent exact evaluator, gives the run's energy and delay
    to the bit (as the ``fused`` phase checks its winners); each fused
    supervised run exits 0, merges with no candidate left, and its
    results equal the clean run's bit for bit (``sweep_ctl._sig``, as
    ``--verify-clean`` compares them); the children's metrics snapshots
    show ``group_eval_fused.misses`` above 0 and each child's
    ``fused_eval.launches`` within (iterations - 2) and iterations times
    the tasks it ran (``engine.tasks``: an iteration whose proposals are
    all cached launches none); ``obs_report`` renders the supervisor's
    run dir and each child's.  A child a ``kill`` fault ends writes no
    snapshot, so the launches counted are those of the children that
    finished.  Not gated: seconds, candidates a second and the report's
    phase rows.  Returns the two lines and the finished children's
    ``fused_eval`` and ``segment_replay`` launches over the fused runs."""
    from repro_torch import obs
    from repro_torch.core.dse import run_dse
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.explore import remaining_candidate_indices
    from repro_torch.dist.faults import FAULT_KINDS
    from repro_torch.dist.supervisor import (SweepSpec, read_state,
                                             supervised_results)
    from repro_torch.launch import sweep_ctl
    from repro_torch.obs import report as obs_report

    root = REPORTS / "sweep"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    def launch(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = sweep_ctl.main(["launch", *argv])
        return rc, buf.getvalue(), time.perf_counter() - t0

    def events(out):
        counts = {}
        for e in read_state(out / "supervisor_state.jsonl")["events"]:
            counts[e["ev"]] = counts.get(e["ev"], 0) + 1
        return counts

    t_phase = time.perf_counter()
    quick = {}
    for kind in FAULT_KINDS:
        out = root / f"quick-{kind}"
        rc, text, secs = launch(["--out", str(out), "--fault", kind,
                                 *SWEEP_QUICK_ARGV])
        quick[kind] = {"rc": rc, "seconds": secs,
                       "verify_clean": "verify-clean: OK" in text,
                       "events": events(out)}
        if rc != 0 or not quick[kind]["verify_clean"]:
            raise AssertionError(f"sweep:quick, fault {kind}: rc {rc}\n"
                                 f"{text[-2000:]}")
    quick_line = {"phase": "sweep:quick", "argv": SWEEP_QUICK_ARGV,
                  "faults": quick,
                  "seconds": time.perf_counter() - t_phase}

    t_fused = time.perf_counter()
    spec = SweepSpec(**SWEEP_FUSED_SPEC)
    spec_path = root / "fused.spec.json"
    spec_path.write_text(spec.to_json() + "\n")
    cands, wls, cfg = (spec.build_candidates(), spec.build_workloads(),
                       spec.build_cfg())
    t0 = time.perf_counter()
    clean = run_dse(cands, wls, dataclasses.replace(cfg, keep_mappings=True),
                    use_sa=spec.use_sa, screen_keep=spec.screen_keep)
    clean_s = time.perf_counter() - t0
    want = sweep_ctl._sig(clean)
    for p in clean:
        for name, got in p.per_workload.items():
            r = Evaluator(p.arch, wls[name]).evaluate(p.mappings[name],
                                                      cfg.batch)
            if got != (r.energy_j, r.delay_s):
                raise AssertionError(f"sweep:fused, the clean run's winner "
                                     f"on {p.arch.label()} reports {got}, "
                                     f"the exact re-evaluation "
                                     f"{(r.energy_j, r.delay_s)}")
    iters = SWEEP_FUSED_SPEC["sa"]["iters"]
    runs, launched = {}, {"fused_eval": 0, "segment_replay": 0}
    for kind in SWEEP_FUSED_FAULTS:
        out, run_dir = root / f"fused-{kind}", root / f"fused-{kind}.obs"
        obs.enable(run_dir)
        try:
            rc, text, secs = launch(["--spec", str(spec_path), "--out",
                                     str(out), "--hosts", "2", "--fault",
                                     kind, "--fault-seed", "0"])
        finally:
            obs.disable()
            obs.metrics.reset()
        if rc != 0:
            raise AssertionError(f"sweep:fused, fault {kind}: rc {rc}\n"
                                 f"{text[-2000:]}")
        merged = out / "merged.jsonl"
        left = remaining_candidate_indices(cands, wls, cfg, merged,
                                           use_sa=spec.use_sa)
        got = sweep_ctl._sig(supervised_results(spec, merged))
        children = {d.name: json.loads((d / "metrics.json").read_text())
                    for d in sorted(run_dir.iterdir())
                    if (d / "metrics.json").exists()}
        count = lambda key: sum(int(m["counters"].get(key, 0))
                                for m in children.values())
        ckpts = sorted(str(p) for p in out.glob("shard*.jsonl"))
        reports = {name: obs_report.render_report(run=run_dir / name,
                                                  ckpts=ckpts)
                   for name in ["", *children]}
        first = next(iter(children))
        per_child = {name: {
            "tasks": int(m["counters"].get("engine.tasks", 0)),
            "fused_eval_launches": int(m["counters"].get(
                "fused_eval.launches", 0))} for name, m in children.items()}
        runs[kind] = {
            "seconds": secs, "candidates_per_s": len(cands) / secs,
            "remaining": len(left), "verify_clean": got == want,
            "events": events(out), "children": sorted(children),
            "group_eval_fused_misses": count("group_eval_fused.misses"),
            "fused_eval_launches": count("fused_eval.launches"),
            "segment_replay_launches": count("segment_replay.launches"),
            "per_child": per_child,
            "report_lines": {k or "supervisor": len(v.splitlines())
                             for k, v in reports.items()},
            "phase_rows": {first: obs_report.phase_rows(children[first])}}
        for k in launched:
            launched[k] += runs[kind][f"{k}_launches"]
        launched_per_task = all(
            c["tasks"] and (iters - 2) * c["tasks"]
            <= c["fused_eval_launches"] <= iters * c["tasks"]
            for c in per_child.values())
        if left or got != want or not runs[kind]["group_eval_fused_misses"] \
                or not launched_per_task:
            raise AssertionError(f"sweep:fused, fault {kind}: {runs[kind]}")
    fused_line = {"phase": "sweep:fused", "spec": SWEEP_FUSED_SPEC,
                  "candidates": len(cands), "shards": spec.n_shards,
                  "clean_seconds": clean_s,
                  "clean_candidates_per_s": len(cands) / clean_s,
                  "winners_equal_exact": True,
                  "runs": runs, "fused_eval_launches": launched["fused_eval"],
                  "launches_of": "the shard children that finished (a child "
                                 "a kill fault ends writes no snapshot)",
                  "clock": "host seconds on the machine that holds the card",
                  "seconds": time.perf_counter() - t_fused}
    return quick_line, fused_line, launched


def cost_kernel_summary(cost_timed: dict, launches: dict,
                        sweep_launches: dict) -> list:
    """The ``kernels`` entries of the cost model's kernels: ``launches``
    summed over the fused phase and the fused sweep's shard children that
    finished (``per_path`` splits them; a child a ``kill`` fault ends
    writes no snapshot), the other numbers from the kernel line at
    the fused phase's shape (granite layout; the lockstep batch for
    ``fused_eval``, the screen batch the phase replays for
    ``segment_replay``), one launch; ``max_abs_err`` over all of the
    kernel's lines."""
    out = []
    for name, (source, replaces) in COST_KERNEL_FILES.items():
        lines = [ln for (k, _, _), ln in cost_timed.items() if k == name]
        main, = [ln for ln in lines if ln["main_path"]]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name] + sweep_launches[name],
            "per_path": {"fused": launches[name],
                         "sweep:fused": sweep_launches[name]},
            "sweep_launches_of": "the shard children that finished",
            "max_abs_err": max(ln["max_abs_err"] for ln in lines),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "host_issued_ms": main["host_issued_ms"],
            "per": f"one launch at B={main['B']} on the {main['layout']} "
                   f"layout ({main['arch']})"})
        if main["library_ms"] is None:
            out[-1]["library"] = main["library"]
    return out


def flash_bf16_line(randn, B, heads, Sq, Sk, hd, causal, main_path) -> dict:
    """One bf16 flash kernel line at a serve shape: (B, heads, Sq, Sk, hd)
    from ``randn``, ``causal`` or not, q_offset 0, against the plain
    version on the upcast inputs (2e-2), with its device time, the plain
    version's, bf16 ``scaled_dot_product_attention``'s and the bound at
    bf16 rates."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import flash_attention_mha

    q = randn(B, heads, Sq, hd).bfloat16()
    k, v = (randn(B, heads, Sk, hd).bfloat16() for _ in range(2))
    got = flash_attention_mha(q, k, v, causal=causal)
    same = torch.equal(got, flash_attention_mha(q, k, v, causal=causal))
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    shape = {"B": B, "H": heads, "Sq": Sq, "Sk": Sk, "D": hd,
             "causal": int(causal)}
    line = {"phase": "kernel", "kernel": "flash_attention_mha",
            "dtype": "bf16", "shape": shape, "q_offset": 0,
            "route": flash_attention.kernel_route(q, k, v),
            "arith": ARITH_BF16["flash_attention_mha"],
            "main_path": main_path, **FLASH_BF16_TOL,
            "max_abs_err": (got.float() - want).abs().max().item(),
            "repeat_bit_equal": same,
            **bf16_bounds("flash_attention_mha", shape)}
    line["bound_3xtf32_ms"] = line["bound_ms"]           # bf16 operands
    line["ms"] = time_ms(lambda: flash_attention_mha(q, k, v, causal=causal))
    line["host_issued_ms"] = time_ms(
        lambda: flash_attention_mha(q, k, v, causal=causal), device=False)
    line["plain_ms"] = time_ms(lambda: ref.attention_ref(q, k, v,
                                                         causal=causal))
    line["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
    emit(line)
    if not (same and torch.allclose(got.float(), want, **FLASH_BF16_TOL)):
        raise AssertionError(f"serve flash disagrees at {shape}, or with "
                             f"itself")
    return line


def serve_kernel_lines(dev, keys, main_path) -> dict:
    """Kernel lines at a serve phase's launch shapes, once per distinct
    launch key (``serve_wave_keys``): flash on bf16 (B, heads, Sq, Sk, head
    dim), causal or not, as the prefill runs it; the SSD chunk kernel
    mixed (x and cum f32, B and C bf16, as the path's bf16 compute hands
    them; and, not kept, all f32 as its f32 compute does) at (B * ceil(L /
    128), 128, H, P, N), each launched twice and held to repeat its bits;
    the state pass on (B, ceil(L /
    128), 128, H, P, N, G = 1) by the route the rule picks.  Each against
    its plain version on the same inputs (flash on the upcast inputs,
    2e-2; the SSD kernels 1e-4), with its device time, the plain
    version's, the library call's (bf16 ``scaled_dot_product_attention``;
    none for the SSD kernels) and the bound (bf16 rates for flash).
    Returns them by launch key."""
    import torch

    from repro_torch.kernels import mamba_ssd, ref
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.realize.measure import launch_cost

    gen = torch.Generator(device=dev).manual_seed(2)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    timed = {}
    for key in sorted(set(keys), key=repr):
        kernel, shp = key
        if key in timed:
            continue
        if kernel == "flash_attention_mha":
            B, heads, Sq, Sk, hd, causal = shp[:6]
            timed[key] = flash_bf16_line(randn, B, heads, Sq, Sk, hd,
                                         bool(causal), main_path)
        elif kernel == "ssd_chunk_dual":
            # the path's bf16 compute launches the mixed instance (kept
            # for the summary); its f32 compute, checked beside it, the
            # f32 one
            shape = dict(zip(("BC", "Q", "H", "P", "N"), shp))
            for dtype in ("mixed", "f32"):
                x, cum, Bm, Cm = ssd_inputs(randn, *shp, dtype)
                got = ssd_chunk_dual(x, cum, Bm, Cm)
                again = ssd_chunk_dual(x, cum, Bm, Cm)
                want = ref.ssd_chunk_ref(x, cum, Bm, Cm)
                torch.cuda.synchronize()
                line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                        "dtype": dtype, "shape": shape,
                        "route": mamba_ssd.kernel_route(x, Bm, Cm),
                        "heads_per_block": mamba_ssd.heads_per_block(x, Bm),
                        "arith": ARITH_MIXED if dtype == "mixed"
                        else ARITH["ssd_chunk_dual"],
                        "main_path": main_path if dtype == "mixed"
                        else f"{main_path} (f32 compute)",
                        **SSD_TOL, "max_abs_err": max(
                            (g - w).abs().max().item()
                            for g, w in zip(got, want)),
                        "repeat_bit_equal": all(
                            torch.equal(g, a) for g, a in zip(got, again)),
                        **(mixed_bounds(shape) if dtype == "mixed" else
                           bounds(*launch_cost("ssd_chunk_dual", shape)))}
                line["ms"] = time_ms(lambda: ssd_chunk_dual(x, cum, Bm, Cm))
                line["host_issued_ms"] = time_ms(
                    lambda: ssd_chunk_dual(x, cum, Bm, Cm), device=False)
                line["plain_ms"] = time_ms(
                    lambda: ref.ssd_chunk_ref(x, cum, Bm, Cm))
                line["library_ms"] = None
                line["library"] = "none: no single PyTorch call computes it"
                emit(line)
                if not line["repeat_bit_equal"] or not all(
                        torch.allclose(g, w, **SSD_TOL)
                        for g, w in zip(got, want)):
                    raise AssertionError(f"serve ssd_chunk_dual {dtype} "
                                         f"disagrees or does not repeat "
                                         f"its bits at {shape}")
                if dtype == "mixed":
                    timed[key] = line
                del x, cum, Bm, Cm, got, again, want
        elif kernel in STATE_KERNELS:
            for k, line in check_state_pass(
                    randn, *shp, False, timed=True,
                    main_path=main_path).items():
                timed[(k, shp)] = line
    return timed


def serve_wave_keys(arch, B, L, dev) -> list:
    """The (kernel, shape) of every kernel launch of one served wave of B
    slots with prompts padded to L.  A decoder LM, by ``SERVE_ARCHS``:
    flash once an attention application, the SSD chunk kernel and the
    kernels of the route the state pass takes (at the wave's shape) once
    a Mamba-2 layer.  The encoder-decoder, by the reference's flash rule
    (``Sq * Sk > FLASH_RULE`` over the full key length): the encoder's
    self-attention on the wave's L frames (L x L), each decoder layer's
    self-attention on the ``SERVE_MAX_SEQ``-position cache (L x max_seq;
    the kernel reads the L written keys) and cross-attention (L x L);
    decode steps take the scores path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_state
    cfg = get_config(arch)
    if cfg.family == "encdec":
        flash = lambda causal: ("flash_attention_mha", (
            B, cfg.n_heads, L, L, cfg.hd, causal, 0, "bf16"))
        square = L * L > FLASH_RULE
        return [flash(0)] * (cfg.n_enc_layers if square else 0) \
            + [flash(1)] * (cfg.n_layers if L * SERVE_MAX_SEQ > FLASH_RULE
                            else 0) \
            + [flash(0)] * (cfg.n_layers if square else 0)
    n_flash, n_ssm, heads, hd, H, P, N = SERVE_ARCHS[arch]
    nc = -(-L // 128)
    state = (B, nc, 128, H, P, N, 1)
    return [("flash_attention_mha", (B, heads, L, L, hd, 1, 0, "bf16"))] \
        * n_flash \
        + [("ssd_chunk_dual", (B * nc, 128, H, P, N))] * n_ssm \
        + [(k, state) for k in ssd_state.route_kernels(B, H, P, N, dev)] \
        * n_ssm


def serve_path(arch: str) -> str:
    """The name of a serve phase in the per-pass summary: ``serve`` for
    zamba2-1.2b (as before mamba2-370m served), ``serve:<arch>`` else."""
    return "serve" if arch == SERVE_ARCH else f"serve:{arch}"


def serve_check(cfg, params, batch, dev, max_seq=SERVE_MAX_SEQ) -> dict:
    """The prefill of ``batch`` and ``SERVE_CHECK_STEPS`` decode steps
    four ways on the card, each on its own ``max_seq`` cache and all fed
    the greedy tokens of the first: through the kernels and with
    ``use_kernels=False``, in the config's bf16 compute and in f32 compute
    (the same parameters).  Per step, the largest difference relative to
    the largest logit of: kernels against plain in f32 (the kernels'
    error: gated at ``SERVE_TOL``); kernels against plain in bf16; and
    the plain route's bf16 against its f32 (the bf16 rounding the served
    numerics carry, which a deep random-init model amplifies: the bf16
    gap is gated at the larger of ``SERVE_TOL`` and that)."""
    import torch

    from repro_torch.models import model_api
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    slots = batch["tokens"].shape[0]
    feed, logits = None, {}
    for cdt in ("bfloat16", "float32"):
        api = model_api(cfg.replace(compute_dtype=cdt))
        for uk in (True, False):
            cache = api.init_cache(slots, max_seq, device=dev)
            lg, cache = api.prefill(params, batch, cache, use_kernels=uk)
            out, cur_feed = [lg], []
            for step in range(SERVE_CHECK_STEPS):
                cur = (lg.argmax(dim=-1).to(torch.int32)[:, None]
                       if feed is None else feed[step])
                cur_feed.append(cur)
                lg, cache = api.decode_step(params, cur, cache,
                                            use_kernels=uk)
                out.append(lg)
            feed = feed or cur_feed
            logits[(cdt, uk)] = out
            del cache
    torch.cuda.synchronize()
    pairs = {"f32_kernels_vs_plain": (("float32", True), ("float32", False)),
             "bf16_kernels_vs_plain": (("bfloat16", True),
                                       ("bfloat16", False)),
             "bf16_plain_vs_f32_plain": (("bfloat16", False),
                                         ("float32", False))}
    line = {k: [rel(a, b) for a, b in zip(logits[x], logits[y])]
            for k, (x, y) in pairs.items()}
    bf16_bound = [max(SERVE_TOL, g) for g in line["bf16_plain_vs_f32_plain"]]
    line.update({
        "rel_tol": SERVE_TOL, "slots": int(slots),
        "max_rel_err": max(line["f32_kernels_vs_plain"]),
        "bf16_within_rounding": all(
            e <= b for e, b in zip(line["bf16_kernels_vs_plain"],
                                   bf16_bound)),
        "greedy_tokens_equal_bf16": [
            int((a.argmax(-1) == b.argmax(-1)).sum().item()) for a, b in
            zip(logits[("bfloat16", True)], logits[("bfloat16", False)])],
        "steps": "prefill, then teacher-forced decode steps"})
    return line


def serve_gate(name: str, check: dict) -> None:
    """Raise unless ``serve_check``'s kernel route is within its gates."""
    if check["max_rel_err"] > SERVE_TOL or not check["bf16_within_rounding"]:
        raise AssertionError(f"{name}: the kernel route against the plain "
                             f"route: {check}")


def whisper_shape_check(cfg, params, dev) -> dict:
    """The encoder-decoder at whisper's own shape: ``WHISPER_SLOTS``
    clips of ``WHISPER_FRAMES`` seeded frame embeddings (30 s of audio)
    and ``WHISPER_TEXT`` decoder tokens (whisper's text context) in one
    prefill, through the kernels in the served bf16 compute, with the
    launch counts set to 0 just before: 12 encoder flash launches at
    1500 x 1500 and 12 cross-attention launches at 448 x 1500, none for
    the decoder's self-attention (448 x 452 is under the rule).  The cache
    holds ``WHISPER_TEXT + SERVE_CHECK_STEPS`` positions, so that the
    checked decode steps have room.  Then the prefill and the decode steps
    against the plain route (``serve_check``) and a kernel line at each of
    the two flash shapes."""
    import torch

    from repro_torch.models import model_api
    from repro_torch.models.frontends import fake_audio_frames
    gen = torch.Generator(device=dev).manual_seed(3)
    B, frames, T = WHISPER_SLOTS, WHISPER_FRAMES, WHISPER_TEXT
    batch = {"embeds": fake_audio_frames(gen, B, frames, cfg.d_model, dev),
             "tokens": torch.randint(1, cfg.vocab, (B, T), generator=gen,
                                     device=dev, dtype=torch.int32)}
    max_seq = T + SERVE_CHECK_STEPS
    api = model_api(cfg)
    wrappers = kernel_wrappers()
    cache = api.init_cache(B, max_seq, device=dev)
    api.prefill(params, batch, cache)                # warm-up, not counted
    cache = api.init_cache(B, max_seq, device=dev)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    del cache
    flash = lambda Sq: ("flash_attention_mha", (B, cfg.n_heads, Sq, frames,
                                                cfg.hd, 0, 0, "bf16"))
    keys = [flash(frames)] * cfg.n_enc_layers + [flash(T)] * cfg.n_layers
    want = {k: sum(1 for key in keys if key[0] == k) for k in wrappers}
    check = serve_check(cfg, params, batch, dev, max_seq=max_seq)
    lines = serve_kernel_lines(dev, keys, "whisper-shape")
    line = {"slots": B, "frames": frames, "tokens": T, "max_seq": max_seq,
            "prefill_s": prefill_s, "launches": launches,
            "launches_want": want,
            "logits_finite": bool(torch.isfinite(logits).all().item()),
            "kernel_vs_plain": check,
            "flash_ms": {f"{k[1][2]}x{k[1][3]}": ln["ms"]
                         for k, ln in lines.items()}}
    if launches != want or not line["logits_finite"]:
        raise AssertionError(f"whisper shape: launched {launches}, not "
                             f"{want}, or logits not finite")
    serve_gate("whisper shape", check)
    return line


def run_serve(dev, arch):
    """A ``serve`` phase (``SERVE_*``): ``arch`` at full width and depth
    from the port's seeded ``init_params`` on the card, a ``Server``
    answering ``SERVE_REQUESTS`` requests, after one short warm-up wave
    (library handles, the allocator), with the launch counts set to 0 just
    before the counted run.  Gates: every request answered, the launches a
    wave by ``serve_wave_keys`` (the state pass's by the route it takes at
    the wave's shape; the encoder-decoder's flash by the reference's
    rule), the kernel route within ``SERVE_TOL`` of the plain route; for
    the encoder-decoder also ``whisper_shape_check``.  Returns the line,
    the (B, L) of each wave and the launch keys of the run."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_state
    from repro_torch.models import model_api
    from repro_torch.nn.params import count_params, param_bytes
    from repro_torch.runtime.serve_loop import Request, Server

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    encdec = cfg.family == "encdec"
    if encdec:
        if (cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
                cfg.hd, cfg.d_ff, cfg.vocab) != SERVE_ENCDEC[arch]:
            raise AssertionError(f"SERVE_ENCDEC[{arch!r}] does not match "
                                 f"the config")
    else:
        _, n_ssm, _, _, H, P, N = SERVE_ARCHS[arch]
        if (cfg.n_layers, cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
                cfg.ssm_headdim, cfg.ssm_state) != (n_ssm, H, P, N):
            raise AssertionError(f"SERVE_ARCHS[{arch!r}] does not match the "
                                 f"config")
    api = model_api(cfg)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    lo, hi = SERVE_PROMPT
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(lo, hi + 1)))
               .astype(np.int32) for _ in range(SERVE_REQUESTS)]
    srv = Server(cfg, params, max_batch=SERVE_MAX_BATCH,
                 max_seq=SERVE_MAX_SEQ)
    costs = []
    run_wave = srv.executor.run_wave

    def recording(wave):
        out = run_wave(wave)
        costs.append(out[2])
        return out

    srv.executor.run_wave = recording
    srv.submit(Request(rid=-1, prompt=prompts[0][:lo], max_new=2))
    srv.run_until_empty()                            # warm-up, not counted
    costs.clear()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    for i, p in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW))
    t0 = time.perf_counter()
    results = srv.run_until_empty()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    waves = [prompts[i:i + SERVE_MAX_BATCH]
             for i in range(0, SERVE_REQUESTS, SERVE_MAX_BATCH)]
    shapes = [(len(w), max(len(p) for p in w)) for w in waves]
    keys = [key for B, L in shapes for key in serve_wave_keys(arch, B, L,
                                                              dev)]
    routes = [] if encdec else [
        ssd_state.state_route(B, H, P, N, ssd_state.sm_count(dev))
        for B, _ in shapes]
    want = {k: sum(1 for key in keys if key[0] == k) for k in wrappers}
    n_tok = sum(len(r.tokens) for r in results)
    steps = [t for c in costs for t in c.step_s]
    toks = srv.executor._pad_wave(waves[0])
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if cfg.frontend in ("patch", "audio"):
        batch["embeds"] = torch.zeros(toks.shape + (cfg.d_model,),
                                      dtype=torch.bfloat16, device=dev)
    check = serve_check(cfg, params, batch, dev)
    line = {"phase": "serve", "arch": arch, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": count_params(params),
            "param_gb": param_bytes(params) / 1e9,
            "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "init_s": init_s,
            "max_batch": SERVE_MAX_BATCH, "max_seq": SERVE_MAX_SEQ,
            "max_new": SERVE_MAX_NEW, "requests": len(results),
            "tokens": n_tok, "waves": len(costs),
            "wave_shapes": [list(s) for s in shapes],
            "prefill_s": [c.prefill_s for c in costs],
            "decode_ms_median": statistics.median(steps) * 1e3,
            "decode_steps": len(steps), "seconds": seconds,
            "tokens_per_s": n_tok / seconds,
            "latency_s": sorted(r.latency_s for r in results),
            "launches": launches, "launches_want": want,
            "state_routes": routes,
            "peak_mem_gb": peak / 1e9, "kernel_vs_plain": check,
            "clock": "host seconds around work that ends in a synchronize"}
    if encdec:
        line["n_enc_layers"] = cfg.n_enc_layers
        line["flash_per_wave"] = [
            len(serve_wave_keys(arch, B, L, dev)) for B, L in shapes]
    if len(results) != SERVE_REQUESTS \
            or sorted(r.rid for r in results) != list(range(SERVE_REQUESTS)) \
            or not all(len(r.tokens) for r in results):
        raise AssertionError(f"serve: answered {len(results)} requests")
    if launches != want:
        raise AssertionError(f"serve launched {launches}, not {want}")
    serve_gate("serve", check)
    if encdec:
        line["whisper_shape"] = whisper_shape_check(cfg, params, dev)
    line["seconds_phase"] = time.perf_counter() - t_phase
    return line, shapes, keys


def run_serve_trace(dev):
    """``serve_trace``: ``python -m repro_torch.launch.serve`` with
    ``SERVE_TRACE_ARGV`` in this process, on the card: the trace's two
    virtual sections (numpy on the host), each held to
    ``SERVE_TRACE_PINNED`` (the reference's values, which
    tests/test_torch_serve_trace.py holds equal to the port's on the CPU),
    and the measured replay through the port's ``ModelWaveExecutor``,
    which must answer every request, with the launch counts set to 0 just
    before and each wave's launches gated at ``serve_wave_keys`` (48 SSD
    chunk launches and 48 of each kernel of the state pass's route at the
    wave's shape).  Returns the line and the launch keys of the run."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.runtime import serve_loop

    t_phase = time.perf_counter()
    out_path = REPORTS / "serve_trace.jsonl"
    argv = [*SERVE_TRACE_ARGV, "--out", str(out_path)]
    wrappers = kernel_wrappers()
    cls = serve_loop.ModelWaveExecutor
    run_wave, waves = cls.run_wave, []

    def counted(self, wave):
        before = {k: fn.launches for k, fn in wrappers.items()}
        out = run_wave(self, wave)
        L = max(len(self._prompt_of(r)) for r in wave)
        waves.append(((len(wave), L),
                      {k: fn.launches - before[k]
                       for k, fn in wrappers.items()}))
        return out

    for fn in wrappers.values():
        fn.launches = 0
    buf = io.StringIO()
    cls.run_wave = counted
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
    finally:
        cls.run_wave = run_wave
    launches = {k: fn.launches for k, fn in wrappers.items()}
    torch.cuda.synchronize()
    sections = {d["section"]: d for d in map(
        json.loads, out_path.read_text().splitlines())}
    keys, per_wave = [], []
    for (B, L), got in waves:
        wk = serve_wave_keys(SERVE_TRACE_ARCH, B, L, dev)
        want = {k: sum(1 for key in wk if key[0] == k) for k in wrappers}
        per_wave.append({"shape": [B, L], "launches": got,
                         "launches_want": want})
        keys += wk
    pct = lambda s: {k: s[k] for k in ("ttft_s", "e2e_s", "makespan_s",
                                       "n_waves", "mean_occupancy")}
    line = {"phase": "serve_trace", "argv": argv,
            "stdout": buf.getvalue().splitlines(), "sections": {}}
    pinned_equal = {}
    for name, doc in sections.items():
        entry = pct(doc)
        entry["timing"], entry["n"] = doc["timing"], doc["trace"]["n"]
        if "saturation" in doc:
            entry["saturation"] = {k: doc["saturation"][k] for k in (
                "sat_rate_rps", "sat_throughput_rps", "sat_throughput_tok_s",
                "saturated", "ref_p99_e2e_s")}
        line["sections"][name] = entry
        if name in SERVE_TRACE_PINNED:
            pin = SERVE_TRACE_PINNED[name]
            pinned_equal[name] = {
                "bit_equal": all(_nested(entry, k) == v
                                 for k, v in pin.items()),
                "within_1e-12": all(abs(_nested(entry, k) - v)
                                    <= 1e-12 * abs(v)
                                    for k, v in pin.items())}
    measured = sections.get("serve_loop_measured", {})
    ratio = (measured["e2e_s"]["p99"] / sections["serve_loop"]["e2e_s"]["p99"]
             if measured else None)
    line.update({"pinned": pinned_equal, "measured_over_virtual_p99": ratio,
                 "waves": per_wave, "launches": launches,
                 "seconds": time.perf_counter() - t_phase})
    n = int(SERVE_TRACE_SPEC.split("n=")[1].split(",")[0])
    if set(pinned_equal) != set(SERVE_TRACE_PINNED) \
            or not all(p["within_1e-12"] for p in pinned_equal.values()):
        raise AssertionError(f"serve_trace: the virtual sections are not "
                             f"the pinned values: {line['sections']}")
    if not measured or measured["trace"]["n"] != n \
            or sum(B for (B, _), _ in waves) != n:
        raise AssertionError(f"serve_trace: the measured replay answered "
                             f"{measured.get('trace')} of {n} requests")
    if any(w["launches"] != w["launches_want"] for w in per_wave):
        raise AssertionError(f"serve_trace: per-wave launches {per_wave}")
    return line, keys


def _nested(doc: dict, path: str):
    """``doc["a"]["b"]`` for ``path`` ``"a.b"``."""
    for k in path.split("."):
        doc = doc[k]
    return doc


def run_serve_cli() -> dict:
    """``python -m repro_torch.launch.serve --arch zamba2-1.2b`` and
    ``python -m repro_torch.examples.serve_lm --arch zamba2-1.2b`` in this
    process (their defaults: 8 requests of 4-31 prompt tokens, a
    512-position cache; 10 of 4-47, 256), then ``launch.serve --arch
    mamba2-370m``: each serves at full width on the card and answers every
    request."""
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    out, secs = {}, {}
    for name, fn, argv, want in (
            ("launch.serve", serve.main, ["--arch", SERVE_ARCH],
             "[serve] 8 requests"),
            ("examples.serve_lm", serve_lm.main, ["--arch", SERVE_ARCH],
             f"{SERVE_ARCH}: 10 requests"),
            ("launch.serve mamba2-370m", serve.main,
             ["--arch", "mamba2-370m"], "[serve] 8 requests")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        secs[name] = time.perf_counter() - t0
        out[name] = buf.getvalue().splitlines()
        if not any(want in ln for ln in out[name]):
            raise AssertionError(f"{name} {argv}: {out[name]}")
    return {"phase": "serve_cli", "arch": [SERVE_ARCH, "mamba2-370m"],
            "stdout": out, "seconds": secs}


def train_eval_keys(arch: str, B: int, L: int, dev) -> list:
    """The (kernel, shape) of every launch of one eval forward of (B, L)
    tokens through the kernels: a dense model's attention once a layer,
    on the flash kernel where the reference's rule takes the flash path
    (bf16, the kv heads repeated to the query heads); an SSD model's
    launches of a served wave of the same shape (``serve_wave_keys``)."""
    from repro_torch.configs import get_config
    if arch in SERVE_ARCHS:
        return serve_wave_keys(arch, B, L, dev)
    cfg = get_config(arch)
    return [("flash_attention_mha", (B, cfg.n_heads, L, L, cfg.hd, 1, 0,
                                     "bf16"))] \
        * (cfg.n_layers if L * L > FLASH_RULE else 0)


def train_eval(cfg, params, batch, keys) -> dict:
    """The trained parameters on ``batch`` four ways under
    ``torch.no_grad``: the kernels and the plain routes, in the config's
    bf16 compute and in f32 compute, the launch counts set to 0 just
    before the first (the kernels, bf16) and read just after.  Each gives
    the logits (``models.lm.forward``, ``mode="train"``) and from them the
    NLL as ``loss_fn`` takes it.  Gates, the serve gate: the kernel
    route's NLL (relative) and logits (relative to the largest plain
    logit) within ``SERVE_TOL`` of the plain route's in f32 compute and,
    in bf16, within the larger of ``SERVE_TOL`` and the plain route's own
    bf16-vs-f32 gap; every NLL finite; the launches exactly ``keys``.
    Also: the kernel route under autograd raises (the kernels have no
    backward)."""
    import torch

    from repro_torch.models import lm, model_api
    from repro_torch.nn.layers import softmax_cross_entropy
    wrappers = kernel_wrappers()
    logits, nll = {}, {}
    for cdt in ("bfloat16", "float32"):
        c = cfg.replace(compute_dtype=cdt)
        for uk in (True, False):
            if (cdt, uk) == ("bfloat16", True):
                for fn in wrappers.values():
                    fn.launches = 0
            with torch.no_grad():
                lg, _, _ = lm.forward(c, params, batch, mode="train",
                                      use_kernels=uk)
                nll[(cdt, uk)] = softmax_cross_entropy(
                    lg, batch["labels"], batch.get("mask")).item()
            logits[(cdt, uk)] = lg
            if (cdt, uk) == ("bfloat16", True):
                launches = {k: fn.launches for k, fn in wrappers.items()}
    pairs = {"f32_kernels_vs_plain": (("float32", True), ("float32", False)),
             "bf16_kernels_vs_plain": (("bfloat16", True),
                                       ("bfloat16", False)),
             "bf16_plain_vs_f32_plain": (("bfloat16", False),
                                         ("float32", False))}
    line = {"batch": list(batch["labels"].shape), "rel_tol": SERVE_TOL,
            "nll": {f"{c}/{'kernels' if uk else 'plain'}": v
                    for (c, uk), v in nll.items()}}
    for what, rel in (
            ("nll", lambda a, b: abs(nll[a] - nll[b]) / abs(nll[b])),
            ("logits", lambda a, b: ((logits[a] - logits[b]).abs().max()
                                     / logits[b].abs().max()).item())):
        errs = {k: rel(*ab) for k, ab in pairs.items()}
        line[f"{what}_rel"] = errs
        if not errs["f32_kernels_vs_plain"] <= SERVE_TOL \
                or not errs["bf16_kernels_vs_plain"] <= max(
                    SERVE_TOL, errs["bf16_plain_vs_f32_plain"]):
            raise AssertionError(f"train eval: the kernel route's {what} "
                                 f"against the plain route's: {line}")
    del logits
    want = {k: sum(1 for key in keys if key[0] == k) for k in wrappers}
    one = {k: v[:1] for k, v in batch.items()}
    try:
        model_api(cfg).loss_fn(params, one, use_kernels=True)
        refused = False
    except RuntimeError as e:
        refused = "no backward" in str(e)
    line.update({"launches": launches, "launches_want": want,
                 "kernel_route_under_grad_raises": refused})
    if launches != want or not refused \
            or not all(math.isfinite(v) for v in nll.values()):
        raise AssertionError(f"train eval: {line}")
    return line


def profile_train_step(cfg, params, batch, step_ms: float) -> dict:
    """One more train step (``make_train_step``, the config's AdamW at
    ``TRAIN_LR``) of the trained parameters on ``batch`` under
    ``torch.profiler`` (device activity only): the device time of its
    kernels and copies, the device's idle share over the phase's median
    step wall without the profiler (``step_ms``), the profiled wall, the
    kernel launches and the kernels that take the most device time, by
    name.  Not gated.  It runs after the train phases' timed steps and
    before ``profile``: launches that follow a profiler session were
    slower (``profile_ssd_forward``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_train_step, train_state
    from repro_torch.optim.adamw import AdamWConfig
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))
    state = train_state(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        loss = metrics["loss"].item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    REPORTS.mkdir(parents=True, exist_ok=True)
    trace = REPORTS / f"chip_smoke.train.{cfg.name}.trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events
              if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    device_ms = sum(e["dur"] for e in kernels + copies) / 1e3
    by_name = {}
    for e in kernels:
        n, ms = by_name.get(e["name"][:80], (0, 0.0))
        by_name[e["name"][:80]] = (n + 1, ms + e["dur"] / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    trace.unlink()
    return {"phase": "profile", "via": "train_step", "arch": cfg.name,
            "gated": False, "loss": loss, "step_ms_median": step_ms,
            "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / step_ms,
            "kernel_launches": len(kernels), "copies": len(copies),
            "top_kernels": [{"name": k, "launches": n, "device_ms": ms}
                            for k, (n, ms) in top]}


def run_train(dev, arch):
    """A ``train`` phase (``TRAIN_*``): ``arch`` at full width and depth
    from the port's seeded ``init_params`` on the card, trained by
    ``Trainer`` for ``TRAIN_STEPS`` steps with a checkpoint at the middle,
    every kernel's launch count set to 0 just before; then the newest
    checkpoint dropped and the second half run again from the middle one
    (``Trainer.run(resume=True)``).  Gates: no kernel launched by the
    steps, every loss and grad_norm finite, the mean of the last 3 losses
    below the mean of the first 3, the resumed losses equal to the
    straight run's within ``TRAIN_RESUME_RTOL``, and ``train_eval`` of the
    final parameters.  Not gated: step ms (median), tokens a second, peak
    memory, the seconds the loop blocked on each checkpoint save (the
    snapshot to host; the write runs in a thread) and waiting for the last
    write, and the restore's seconds.  Returns the line, the eval's
    launch keys and (config, trained parameters, eval batch)."""
    import shutil
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.steps import to_device
    from repro_torch.nn.params import count_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
            cfg.vocab) != TRAIN_ARCHS[arch]:
        raise AssertionError(f"TRAIN_ARCHS[{arch!r}] does not match the "
                             f"config")
    B, S, half = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS // 2
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    ckdir = REPORTS / "train_ckpt" / arch
    shutil.rmtree(ckdir, ignore_errors=True)
    tcfg = TrainConfig(steps=TRAIN_STEPS, ckpt_every=half,
                       ckpt_dir=str(ckdir), keep=2, log_every=1,
                       opt=AdamWConfig(lr=TRAIN_LR,
                                       warmup_steps=TRAIN_WARMUP,
                                       total_steps=TRAIN_STEPS))
    timing = {"save_s": [], "wait_s": [], "restore_s": []}

    def timed(trainer, name, key):
        fn = getattr(trainer.mgr, name)

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            timing[key].append(time.perf_counter() - t0)
            return out
        setattr(trainer.mgr, name, wrapper)

    wrappers = kernel_wrappers()
    runs, logs = [], []
    for resume in (False, True):
        trainer = Trainer(cfg, data, tcfg, device=dev)
        for name, key in (("save", "save_s"), ("wait", "wait_s"),
                          ("restore_latest", "restore_s")):
            timed(trainer, name, key)
        if resume:
            for suffix in (".npz", ".json"):
                trainer.mgr._path(TRAIN_STEPS).with_suffix(suffix).unlink()
        else:
            for fn in wrappers.values():
                fn.launches = 0
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = trainer.run(resume=resume)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not resume:
            peak = torch.cuda.max_memory_allocated(dev)
            params = out["state"]["params"]
            n_params = count_params(params)
        runs.append({"seconds": seconds, "losses": out["losses"],
                     "stdout": buf.getvalue().splitlines()[:2]})
        logs.append(trainer.metrics_log)
        del trainer, out
    launches = {k: fn.launches for k, fn in wrappers.items()}
    straight, resumed = runs
    dts = [r["dt"] for r in logs[0]]
    step_s = statistics.median(dts)
    a, b = straight["losses"][half:], resumed["losses"]
    resume_err = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    line = {"phase": "train", "arch": arch, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": n_params,
            "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
            "batch": B, "seq": S, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
            "warmup": TRAIN_WARMUP, "losses": straight["losses"],
            "grad_norm": [r["grad_norm"] for r in logs[0]],
            "lr_steps": [r["lr"] for r in logs[0]],
            "resumed_from": half, "resumed_losses": b,
            "resume_max_rel_err": resume_err,
            "resume_rtol": TRAIN_RESUME_RTOL, "resume_bit_equal": a == b,
            "resume_stdout": resumed["stdout"],
            "step_ms": [d * 1e3 for d in dts],
            "step_ms_median": step_s * 1e3,
            "tokens_per_s": B * S / step_s,
            "peak_mem_gb": peak / 1e9, "seconds": straight["seconds"],
            "seconds_resumed": resumed["seconds"],
            "ckpt_save_blocking_s": timing["save_s"],
            "ckpt_wait_s": timing["wait_s"],
            "ckpt_restore_s": timing["restore_s"],
            "step_launches": launches,
            "nvidia_smi": nvidia_smi(),
            "clock": "host seconds around work that ends in a "
                     "synchronize (the step's loss is read to the host)"}
    finite = all(math.isfinite(x) for x in straight["losses"] + b
                 + line["grad_norm"]
                 + [r["grad_norm"] for r in logs[1]])
    first, last = straight["losses"][:3], straight["losses"][-3:]
    if any(launches.values()):
        raise AssertionError(f"train steps launched kernels: {launches}")
    if not finite or sum(last) >= sum(first) \
            or resume_err > TRAIN_RESUME_RTOL or len(b) != half \
            or f"[trainer] resumed from step {half}" not in resumed["stdout"]:
        raise AssertionError(f"train: {line}")
    keys = train_eval_keys(arch, B, S, dev)
    batch = to_device(make_batch(data, TRAIN_STEPS), dev)
    line["eval"] = train_eval(cfg, params, batch, keys)
    shutil.rmtree(ckdir, ignore_errors=True)
    line["seconds_phase"] = time.perf_counter() - t_phase
    return line, keys, (cfg, params, batch)


def run_pipeline(dev):
    """The ``pipeline:smollm-135m`` phase: the Gemini plan of the model's
    layer graph at ``PIPELINE_SEQ`` on the 2 x 2 abstract mesh
    (``plan_for_graph(lm_graph(cfg, seq), mesh_as_arch(2, 2, 1),
    total_batch=4, sa_iters=600)``, the SA's host seconds) executed by
    ``PipelineExec`` at full width and depth on the card (seeded
    ``init_params``), tokens (4, 1024) in 2 microbatches: in the config's
    bf16 compute, every launch count set to 0 just before and read just
    after (the main path's launches), then in f32 compute.  Gates: the
    plan's stage count is the CPU's (``PIPELINE_STAGES``); exactly 60
    flash launches a forward (30 blocks x 2 microbatches) and no other
    kernel; the logits within ``PIPELINE_BF16_ATOL`` (bf16, the example's
    gate) and ``PIPELINE_F32_TOL`` (f32, atol = rtol: the reference
    test's) of the monolithic ``lm.forward(mode="train")``, through the
    kernels and through the plain route (``use_kernels=False``; in bf16
    against the plain route, the larger of the gate and the plain route's
    own bf16-vs-f32 gap, the repo's bf16 rule).  Then the
    example, ``repro_torch.examples.map_to_mesh``, at its defaults on the
    card, which must print ``(OK)``.  Not gated: the pass wall, each
    stage's seconds (summed over the microbatches) and the SA seconds.
    Returns the line and the bf16 pass's launch keys."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.bridge import mesh_as_arch, plan_for_graph
    from repro_torch.core.workloads.lm_graph import lm_graph
    from repro_torch.examples import map_to_mesh
    from repro_torch.models import lm
    from repro_torch.runtime.pipeline import PipelineExec

    t_phase = time.perf_counter()
    cfg = get_config(PIPELINE_ARCH)
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff,
            cfg.vocab) != PIPELINE_DIMS:
        raise AssertionError("PIPELINE_DIMS does not match the config")
    B, S, n_micro = PIPELINE_BATCH, PIPELINE_SEQ, PIPELINE_MICRO
    t0 = time.perf_counter()
    plan = plan_for_graph(lm_graph(cfg, seq=S),
                          mesh_as_arch(*PIPELINE_MESH), total_batch=B,
                          sa_iters=PIPELINE_SA_ITERS)
    sa_s = time.perf_counter() - t0
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, S), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    wrappers = kernel_wrappers()
    keys = [("flash_attention_mha", (B // n_micro, cfg.n_heads, S, S,
                                     cfg.hd, 1, 0, "bf16"))] \
        * (cfg.n_layers * n_micro if S * S > FLASH_RULE else 0)
    want = {k: sum(1 for key in keys if key[0] == k) for k in wrappers}
    line = {"phase": "pipeline", "arch": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "batch": B, "seq": S, "n_micro": n_micro,
            "mesh": list(PIPELINE_MESH), "sa_iters": PIPELINE_SA_ITERS,
            "stages": len(plan.stages), "sa_s": sa_s,
            "cost_delay_s": plan.cost_delay_s,
            "cost_energy_j": plan.cost_energy_j,
            "bf16_atol": PIPELINE_BF16_ATOL, "f32_tol": PIPELINE_F32_TOL}
    with torch.no_grad():                 # the plain route's bf16 gap
        plain_f32, _, _ = lm.forward(cfg.replace(compute_dtype="float32"),
                                     params, {"tokens": tokens},
                                     mode="train", use_kernels=False)
    for cdt in (cfg.compute_dtype, "float32"):
        c = cfg.replace(compute_dtype=cdt)
        pipe = PipelineExec(c, params, plan, devices=[dev])
        pipe.forward(tokens, n_micro=n_micro)              # warm-up
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits = pipe.forward(tokens, n_micro=n_micro)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        run = {"pass_s": wall, "stage_s": pipe.stage_times,
               "stage_s_sum": sum(pipe.stage_times),
               "stages_with_blocks": sum(1 for lo, hi in pipe._ranges
                                         if hi > lo),
               "launches": launches, "launches_want": want,
               "logits_shape": list(logits.shape)}
        for uk in (True, False):
            with torch.no_grad():
                mono, _, _ = lm.forward(c, params, {"tokens": tokens},
                                        mode="train", use_kernels=uk)
            d = (logits - mono).abs()
            route = "kernels" if uk else "plain"
            run[f"max_abs_err_vs_{route}"] = d.max().item()
            if cdt == "float32":
                run[f"within_vs_{route}"] = bool(torch.allclose(
                    logits, mono, atol=PIPELINE_F32_TOL,
                    rtol=PIPELINE_F32_TOL))
            else:
                # against the plain route, bf16's rule (ROADMAP queue 3,
                # decided item 4): the larger of the gate and the plain
                # route's own bf16-vs-f32 gap
                gate = PIPELINE_BF16_ATOL
                if not uk:
                    run["plain_bf16_vs_f32_gap"] = \
                        (mono - plain_f32).abs().max().item()
                    gate = max(gate, run["plain_bf16_vs_f32_gap"])
                run[f"within_vs_{route}"] = \
                    run[f"max_abs_err_vs_{route}"] < gate
            del mono, d
        run["finite"] = bool(torch.isfinite(logits).all())
        line["bf16" if cdt == "bfloat16" else "f32"] = run
        del logits, pipe
        torch.cuda.empty_cache()
        if launches != want or not run["finite"] \
                or not (run["within_vs_kernels"] and run["within_vs_plain"]):
            raise AssertionError(f"pipeline ({cdt}): {run}")
        if cdt == cfg.compute_dtype:
            main_launches = launches
    del plain_f32
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ex = map_to_mesh.main([])
    text = buf.getvalue().splitlines()
    line["example"] = {"stages": len(ex["plan"].stages),
                       "max_abs_err": ex["err"], "sa_s": ex["sa_s"],
                       "last_line": text[-1]}
    line["launches"] = main_launches
    line["nvidia_smi"] = nvidia_smi()
    line["clock"] = ("pass_s and stage_s: host seconds around work that "
                     "ends in a synchronize; sa_s: host seconds")
    line["seconds"] = time.perf_counter() - t_phase
    if line["stages"] != PIPELINE_STAGES or not text[-1].endswith("(OK)"):
        raise AssertionError(f"pipeline: {line['stages']} stages, example "
                             f"{text[-1]!r}")
    return line, keys


def run_dp(dev) -> dict:
    """The ``dp`` phase: ``make_compressed_dp_step`` on a one-rank NCCL
    mesh on the card (``make_host_mesh((1,), ("data",))``, which starts
    its own single-process group), on the reference test's regression
    (W (16, 4) from ``np.random.default_rng(0)``, batch 64 of fresh
    normal rows a step, AdamW lr 0.05 without decay, warmup or clipping,
    ``DP_STEPS`` steps).  Gates: the last loss below 0.05 x the first,
    every loss finite; and ``compressed_grad_sync`` of a (1024, 256) leaf
    with its error state giving the int8 mean of one rank, ``q * scale``,
    and the residual, bit for bit.  The process group is destroyed at the
    end."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         init_error_state, init_opt_state)
    from repro_torch.optim.compressed_dp import (compressed_grad_sync,
                                                 make_compressed_dp_step)

    t_phase = time.perf_counter()
    mesh = make_host_mesh((1,), ("data",))
    try:
        rng = np.random.default_rng(0)
        W_true = torch.as_tensor(rng.normal(size=(16, 4)),
                                 dtype=torch.float32, device=dev)

        def loss_fn(params, batch):
            return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

        ocfg = AdamWConfig(lr=DP_LR, weight_decay=0.0, warmup_steps=0,
                           total_steps=200, min_lr_ratio=1.0, grad_clip=0.0)
        params = {"w": torch.zeros(16, 4, device=dev)}
        opt, err = init_opt_state(params), init_error_state(params)
        step = make_compressed_dp_step(
            loss_fn, lambda p, g, o: adamw_update(ocfg, p, g, o), mesh,
            "data")
        losses = []
        t0 = time.perf_counter()
        for _ in range(DP_STEPS):
            x = torch.as_tensor(rng.normal(size=(DP_BATCH, 16)),
                                dtype=torch.float32, device=dev)
            params, opt, err, metrics = step(params, opt, err,
                                             {"x": x, "y": x @ W_true})
            losses.append(metrics["loss"].item())
        steps_s = time.perf_counter() - t0
        gen = torch.Generator(dev).manual_seed(3)
        g = torch.randn(1024, 256, device=dev, generator=gen)
        e = torch.randn(1024, 256, device=dev, generator=gen) * 0.01
        mean, new_e = compressed_grad_sync({"w": g}, {"w": e},
                                           mesh.get_group("data"))
        gf = g + e
        scale = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        sync_equal = bool(torch.equal(mean["w"], q * scale))
        resid_equal = bool(torch.equal(new_e["w"], (
            gf.double() - q.double() * scale.double()).float()))
        line = {"phase": "dp", "backend": dist.get_backend(),
                "world_size": dist.get_world_size(),
                "mesh": list(mesh.shape), "steps": DP_STEPS,
                "batch": DP_BATCH, "lr": DP_LR, "losses": losses,
                "first": losses[0], "last": losses[-1],
                "last_over_first": losses[-1] / losses[0],
                "steps_s": steps_s,
                "sync_mean_equals_q_scale": sync_equal,
                "sync_residual_equal": resid_equal,
                "wire_bytes": {"compressed": 4 + 2 * g.numel(),
                               "f32": 4 * g.numel()},
                "seconds": time.perf_counter() - t_phase}
    finally:
        dist.destroy_process_group()
    if not (all(math.isfinite(v) for v in losses)
            and losses[-1] < 0.05 * losses[0] and sync_equal
            and resid_equal):
        raise AssertionError(f"dp: {line}")
    return line


def start_dryrun():
    """Start ``python -m repro_torch.launch.dryrun`` for ``DRYRUN_RUNS``
    on the single-pod mesh in a subprocess (the host's CPU, one thread),
    into a fresh JSON under ``results/``.  Returns (process, JSON path,
    start time)."""
    out = REPORTS / "dryrun_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    code = "\n".join([
        "import sys",
        "from repro_torch.launch import dryrun",
        f"for arch, shapes in {DRYRUN_RUNS!r}:",
        "    sys.argv = ['dryrun', '--arch', arch, '--shape', shapes,",
        f"                '--mesh', 'single', '--out', {str(out)!r}]",
        "    try:",
        "        dryrun.main()",
        "    except SystemExit as e:",
        "        print('EXIT', e.code, flush=True)"])
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(SRC),
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, time.perf_counter()


def finish_dryrun(proc, out, t0) -> dict:
    """The ``dryrun`` phase's line: wait for ``start_dryrun``'s process
    (``DRYRUN_TIMEOUT`` from its start; killed past it) and read its
    cells.  Gates: both runs exit 0 and every cell is ``ok`` with its
    three terms, bottleneck, argument and temp bytes."""
    try:
        text, _ = proc.communicate(
            timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    seconds = time.perf_counter() - t0
    recs = json.loads(out.read_text()) if out.exists() else {}
    keys = ("t_compute", "t_memory", "t_collective", "bottleneck",
            "argument_bytes", "output_bytes", "temp_bytes",
            "flops_per_device", "bytes_per_device", "coll_bytes_per_device",
            "coll_by_kind", "compile_s", "lower_s")
    want = [f"{arch}|{shape}|single" for arch, shapes in DRYRUN_RUNS
            for shape in shapes.split(",")]
    line = {"phase": "dryrun", "mesh": "single (16 x 16, a fake 256-rank "
            "group on the host's CPU)", "seconds": seconds,
            "timeout_s": DRYRUN_TIMEOUT,
            "exits": re.findall(r"^EXIT (\S+)$", text, re.M),
            "cells": {k: {f: recs[k].get(f) for f in keys + ("ok",)}
                      if k in recs else None for k in want},
            "chip": "H100 SXM data sheet: 989e12 bf16 FLOP/s, 3.35e12 "
                    "HBM B/s, 900e9 NVLink B/s"}
    bad = [k for k in want if k not in recs or not recs[k].get("ok")
           or any(recs[k].get(f) is None for f in keys)]
    if bad or line["exits"] != ["0"] * len(DRYRUN_RUNS):
        raise AssertionError(f"dryrun: cells {bad} failed or incomplete; "
                             f"exits {line['exits']}; output tail "
                             f"{text[-3000:]}")
    return line


def _sync_s(fn):
    """(fn(), host seconds around it ending in a synchronize)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cells_serve(dev, mesh, arch):
    """The ``cells`` phase's serving half for ``arch``: bf16 weights from
    the port's seeded ``init_params`` at full width and depth, a prefill
    of ``CELLS_PREFILL`` tokens and ``CELLS_DECODE_STEPS`` greedy decode
    steps, once through the eager route (``model_api``) and once through
    ``make_prefill_bundle`` / ``make_decode_bundle`` on the one-rank mesh,
    each run twice and the second counted (launch counts set to 0 just
    before each).  The bundle is fed the eager route's tokens.  Gates: the
    bundle's launches equal the eager route's and ``train_eval_keys``'
    (the kernels the eager prefill launches; decode launches none), the
    logits of every step within ``SERVE_TOL`` of the largest eager logit
    (bit equality is expected on one rank, and the line says whether it
    held), the greedy tokens equal where the logits are bit-equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import model_api

    cfg = get_config(arch)
    api = model_api(cfg)
    S, B = CELLS_PREFILL
    n_dec = CELLS_DECODE_STEPS
    model = api.init_params(torch.Generator(device=dev).manual_seed(0),
                            dev).to(torch.bfloat16)
    params = {n: p.detach() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(1, cfg.vocab, (B, S), generator=gen, device=dev,
                         dtype=torch.int32)
    pb = steps.make_prefill_bundle(cfg, ShapeConfig("card_prefill", S, B,
                                                    "prefill"), mesh)
    db = steps.make_decode_bundle(cfg, ShapeConfig(
        "card_decode", S + n_dec, B, "decode"), mesh)
    wrappers = kernel_wrappers()

    def eager():
        cache = api.init_cache(B, S + n_dec, device=dev)
        (lg, cache), prefill_s = _sync_s(
            lambda: api.prefill(model, {"tokens": toks}, cache))
        logits, feed, ms = [lg], [], []
        for _ in range(n_dec):
            feed.append(logits[-1].argmax(-1).to(torch.int32)[:, None])
            (lg, cache), dt = _sync_s(
                lambda: api.decode_step(model, feed[-1], cache))
            logits.append(lg)
            ms.append(dt * 1e3)
        return logits, feed, prefill_s, ms

    def bundle(feed):
        cache = api.init_cache(B, S + n_dec, device=dev)
        pd, bd, cd = pb.place(params, {"tokens": toks}, cache)
        (lg, cd), prefill_s = _sync_s(lambda: pb.fn(pd, bd, cd))
        logits, ms = [lg.to_local()], []
        for cur in feed:
            td = db.place(None, cur, None)[1]
            (lg, cd), dt = _sync_s(lambda: db.fn(pd, td, cd))
            logits.append(lg.to_local())
            ms.append(dt * 1e3)
        return logits, prefill_s, ms

    def counted(fn, *a):
        fn(*a)                                       # warm-up
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn(*a)
        return out, {k: w.launches for k, w in wrappers.items()}, \
            torch.cuda.max_memory_allocated(dev) / 1e9

    (e_logits, feed, e_prefill, e_ms), e_launches, e_peak = counted(eager)
    (b_logits, b_prefill, b_ms), b_launches, b_peak = counted(bundle, feed)
    keys = train_eval_keys(arch, B, S, dev)
    want = {k: sum(1 for key in keys if key[0] == k) for k in wrappers}
    rel = [((b - e).float().abs().max() / e.float().abs().max()).item()
           for b, e in zip(b_logits, e_logits)]
    bit_equal = all(torch.equal(b, e) for b, e in zip(b_logits, e_logits))
    tokens_equal = [int((b.argmax(-1) == e.argmax(-1)).sum().item())
                    for b, e in zip(b_logits, e_logits)]
    line = {"phase": "cells", "cell": f"{arch}/card_prefill+card_decode",
            "arch": arch, "mesh": list(CELLS_MESH), "prompt": S,
            "batch": B, "decode_steps": n_dec,
            "param_dtype": "bfloat16", "compute_dtype": cfg.compute_dtype,
            "launches": b_launches, "launches_eager": e_launches,
            "launches_want": want, "max_rel_err": max(rel),
            "rel_err_by_step": rel, "rel_tol": SERVE_TOL,
            "bit_equal": bit_equal, "greedy_tokens_equal": tokens_equal,
            "prefill_s": b_prefill, "prefill_s_eager": e_prefill,
            "decode_ms_median": sorted(b_ms)[len(b_ms) // 2],
            "decode_ms_median_eager": sorted(e_ms)[len(e_ms) // 2],
            "peak_mem_gb": b_peak, "peak_mem_gb_eager": e_peak,
            "nvidia_smi": nvidia_smi(),
            "clock": "host seconds around work that ends in a "
                     "synchronize; the second of two runs"}
    if b_launches != e_launches or b_launches != want:
        raise AssertionError(f"cells {arch}: the bundles launched "
                             f"{b_launches}, the eager route {e_launches}, "
                             f"the plan {want}")
    if max(rel) > SERVE_TOL or (bit_equal and tokens_equal
                                != [B] * (n_dec + 1)):
        raise AssertionError(f"cells {arch}: {line}")
    return line, keys


def cells_train(dev, mesh):
    """The ``cells`` phase's training half: ``CELLS_TRAIN_ARCH`` at full
    width and depth (f32 parameters from the port's seeded
    ``init_params``, bf16 compute, remat on), ``CELLS_TRAIN_STEPS`` steps
    of ``make_train_step`` and of ``make_train_bundle`` on the one-rank
    mesh with ``zero1=True`` and then ``False``, each from the same
    weights on the same batches (``make_batch`` of steps 0, 1, ...).
    Gates: every bundle loss within ``CELLS_TRAIN_RTOL`` of the eager
    step's, and no kernel launched (the steps take the plain routes).
    Not gated: step ms (median of the last 11), peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import steps
    from repro_torch.models import model_api
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    cfg = get_config(CELLS_TRAIN_ARCH)
    api = model_api(cfg)
    S, B = CELLS_TRAIN
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    batches = [{k: v for k, v in steps.to_device(make_batch(data, i),
                                                 dev).items()
                if k in ("tokens", "labels")}
               for i in range(CELLS_TRAIN_STEPS)]
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=CELLS_TRAIN_STEPS)
    model = api.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    wrappers = kernel_wrappers()
    runs = {}

    def run(name, step, state, place):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        losses, ms = [], []
        for b in batches:
            b = place(b)
            (state, m), dt = _sync_s(lambda: step(state, b))
            loss = m["loss"]
            losses.append(float(loss.to_local() if hasattr(loss, "to_local")
                                else loss))
            ms.append(dt * 1e3)
        runs[name] = {"losses": losses,
                      "step_ms_median": sorted(ms[1:])[len(ms[1:]) // 2],
                      "first_step_ms": ms[0],
                      "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                      / 1e9,
                      "launches": {k: w.launches
                                   for k, w in wrappers.items()}}
        return state

    run("eager", steps.make_train_step(cfg, ocfg), steps.train_state(model),
        lambda b: b)
    del model
    shape = ShapeConfig("card_train", S, B, "train")
    for zero1 in (True, False):
        tb = steps.make_train_bundle(cfg, shape, mesh, zero1=zero1,
                                     opt_cfg=ocfg)
        p = {n: t.clone() for n, t in init.items()}
        state = tb.place({"params": p, "opt": init_opt_state(p)}, None)[0]
        run(f"bundle_zero1={zero1}", tb.fn, state,
            lambda b: tb.place(None, b)[1])
        del state, p
        torch.cuda.empty_cache()
    eager = runs["eager"]["losses"]
    rel = {k: max(abs(a - b) / abs(b) for a, b in zip(r["losses"], eager))
           for k, r in runs.items() if k != "eager"}
    line = {"phase": "cells", "cell": f"{CELLS_TRAIN_ARCH}/card_train",
            "arch": CELLS_TRAIN_ARCH, "mesh": list(CELLS_MESH), "seq": S,
            "batch": B, "steps": CELLS_TRAIN_STEPS, "lr": TRAIN_LR,
            "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
            "runs": runs, "max_rel_err": rel, "rel_tol": CELLS_TRAIN_RTOL,
            "bit_equal": {k: runs[k]["losses"] == eager for k in rel},
            "nvidia_smi": nvidia_smi(),
            "clock": "host seconds around each step, which ends in a "
                     "synchronize"}
    if any(any(r["launches"].values()) for r in runs.values()) \
            or any(v > CELLS_TRAIN_RTOL for v in rel.values()) \
            or not all(math.isfinite(x) for x in eager):
        raise AssertionError(f"cells train: {line}")
    return line


def run_cells(dev):
    """The ``cells`` phase: the cell bundles on a one-rank NCCL mesh
    (``make_host_mesh(CELLS_MESH)``, which starts its own group, destroyed
    at the end): ``cells_serve`` for each of ``CELLS_SERVE`` and
    ``cells_train``.  Returns the lines and, by serve arch, the prefill's
    launch keys."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(CELLS_MESH)
    try:
        lines, keys = [], {}
        for arch in CELLS_SERVE:
            line, keys[arch] = cells_serve(dev, mesh, arch)
            lines.append(line)
            torch.cuda.empty_cache()
        lines.append(cells_train(dev, mesh))
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return lines, keys


def main() -> int:
    if not (SRC / "repro_torch").is_dir() \
            or not all((FIXTURES / p[1]).exists() for p in PATHS):
        print("chip_smoke.py: run it from the root of a checkout of the "
              "repository (src/repro_torch and the checkpoint fixtures are "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": info})
    sass = {name: _build.sass_text(name) for name in _build.SOURCES}
    if None in sass.values():
        emit({"phase": "sass", "tensor_core": None,
              "note": "the toolkit has no cuobjdump"})
    else:
        counts = {name: _build.tensor_core_counts(text)
                  for name, text in sass.items()}
        gated = {**{name: None for name in _build.TENSOR_CORE_SOURCES},
                 "ssd_state": STATE_HMMA_KERNELS}
        emit({"phase": "sass", "tensor_core": counts,
              "gated": {**{name: "every kernel function"
                           for name in _build.TENSOR_CORE_SOURCES},
                        "ssd_state": list(STATE_HMMA_KERNELS)},
              "bf16_only": _build.BF16_TC_KERNELS,
              "hgmma_tf32_only": _build.TF32_WGMMA_KERNELS,
              "no_product": _build.NO_PRODUCT_KERNELS,
              "bf16_beside_tf32": _build.MIXED_TC_KERNELS})
        faults = [f for name, parts in gated.items()
                  for f in _build.tensor_core_faults(name, counts[name],
                                                     parts)]
        if faults:
            raise AssertionError("tensor-core instructions: "
                                 + "; ".join(faults))

    timed, layer = check_kernels(dev)
    timed_bf16 = check_bf16(dev)
    runs = {path[0]: run_path(path, dev) for path in PATHS}
    loop_line, loop_runs = run_loop(dev, timed)
    emit(loop_line)
    runs.update(loop_runs)
    runs = {k: (launches, program_keys(prog))
            for k, (launches, prog) in runs.items()}
    _, mesh_runs = run_realize_mesh(dev)
    timed.update(mesh_kernel_lines(dev, [k for _, keys in mesh_runs.values()
                                         for k in keys]))
    runs.update(mesh_runs)
    cost_timed = check_cost_kernels(dev)
    fused_line = run_fused(dev)
    emit(fused_line)
    *sweep_lines, sweep_launches = run_sweep()
    for line in sweep_lines:
        emit(line)
    for arch in SERVE_PHASES:
        serve_line, _, serve_keys = run_serve(dev, arch)
        emit(serve_line)
        torch.cuda.empty_cache()
        timed.update(serve_kernel_lines(dev, serve_keys, serve_path(arch)))
        runs[serve_path(arch)] = (serve_line["launches"], serve_keys)
    trace_line, trace_keys = run_serve_trace(dev)
    emit(trace_line)
    torch.cuda.empty_cache()
    timed.update(serve_kernel_lines(dev, trace_keys, "serve_trace"))
    runs["serve_trace"] = (trace_line["launches"], trace_keys)
    emit(run_serve_cli())
    torch.cuda.empty_cache()
    trained = []
    for arch in TRAIN_ARCHS:
        train_line, train_keys, model = run_train(dev, arch)
        emit(train_line)
        torch.cuda.empty_cache()
        timed.update(serve_kernel_lines(dev, train_keys, f"train:{arch}"))
        runs[f"train:{arch}"] = (train_line["eval"]["launches"], train_keys)
        trained.append((*model, train_line["step_ms_median"]))
    for model in trained:
        emit(profile_train_step(*model))
    del trained, model
    torch.cuda.empty_cache()
    pipe_line, pipe_keys = run_pipeline(dev)
    emit(pipe_line)
    torch.cuda.empty_cache()
    timed.update(serve_kernel_lines(dev, pipe_keys,
                                    f"pipeline:{PIPELINE_ARCH}"))
    runs[f"pipeline:{PIPELINE_ARCH}"] = (pipe_line["launches"], pipe_keys)
    emit(run_dp(dev))
    dryrun = start_dryrun()
    try:
        cells_lines, cells_keys = run_cells(dev)
    except BaseException:
        dryrun[0].kill()
        dryrun[0].communicate()
        raise
    for line in cells_lines:
        emit(line)
    for arch, keys in cells_keys.items():
        timed.update(serve_kernel_lines(dev, keys, f"cells:{arch}"))
        runs[f"cells:{arch}"] = (cells_lines[CELLS_SERVE.index(arch)]
                                 ["launches"], keys)
    emit(finish_dryrun(*dryrun))
    emit(profile_ssd_forward(*layer))
    emit({"kernels": per_pass_summary(timed, timed_bf16, runs)
          + cost_kernel_summary(cost_timed, fused_line["launches"],
                                sweep_launches)})
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
