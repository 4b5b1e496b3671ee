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
   (registers, spills).  Then ``sass``: the tensor-core ``HMMA``
   instructions in each built library's SASS, by kernel function, where
   the toolkit has ``cuobjdump``; a kernel function that multiplies on
   the tensor cores without ``HMMA`` fails the run: every function of
   the three tensor-core sources and, in ``ssd_state.cu``, the walk's and
   the split outputs' (``ssd_state_walk``, ``ssd_state_out``); the
   state scan and ``fused_eval.cu`` do no product on the tensor cores,
   so their counts are printed, not gated.
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
   of the largest value).  The SSD chunk kernel's N <= 128 instance
   (``P64 N128``) is timed at the ``mamba2-370m`` serve wave's shape (f32
   and bf16) and at an odd N (4-byte copies); the state pass at the
   ``zamba2-1.2b`` prefill, the ``mamba2-370m`` realization and serve
   shapes, on both routes, each kernel of the route also on its own.  Each
   kernel line names the kernel configuration the launch took (``route``:
   tile, head-dim template or P tile, copy width); the edge shapes drive
   each of them.  The realization paths' shapes also get
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
   and N, D = 40 and 33, P = 130): bf16 operands, held against the plain
   version on the upcast inputs at the reference's bf16 tolerances (GEMM
   atol 0.5 / rtol 5e-2, flash 2e-2; SSD, whose outputs are f32, 1e-4),
   each launch counted and the output type checked; at the path shapes
   also the kernel's, the plain version's and the bf16 library call's
   time and the bound at bf16 rates (989 TFLOP/s dense, 2 bytes an
   element).
4. ``path``, once per realization path: a committed keep_mappings
   checkpoint realized at full width through ``repro_torch.launch.realize
   --calibrate`` (one warm-up pass, then the counted pass, with every
   launch count set to 0 just before it): stages, kernel launches of the
   pass (the state pass's route's kernels once per SSD layer, after the
   chunk kernel; they must equal the plan's declared launches),
   wall, FLOPs and DCI bytes per stage, the predicted totals
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
   Then ``kernel`` lines of the cost model's two kernels (after the
   paths, so that the paths' host-bound passes run in the parent's
   conditions), on two layouts (the reference's fused-pass test arch with
   ``moe-quick``, S-Arch with the granite graph) at the batch of a
   lockstep SA iteration and of a screen: ``fused_eval`` held against its
   plain version on the card and the exact numpy engine (rel 1e-4, the
   same bottleneck, the reference's parity envelope); ``segment_replay``
   against ``np.bincount`` (rtol 2e-4 / atol 1e-2); each with its device
   time, the plain version's, its time as the host issues it, the library
   call's (``index_add_`` for the replay, none for the fused pass), a
   bound from the bytes it must move at the HBM rate, and for the fused
   pass the host time of one whole batch evaluation on each backend.
   Then ``fused``: replica-exchange SA on the granite graph (S-Arch, four
   chains in lockstep), once on the exact numpy engine and once scoring
   proposals with the fused pass on the card, with the cost kernels'
   counts set to 0 just before; proposals a second each way, each winner
   re-evaluated exactly (it must equal the reported cost to the bit); then
   ``analyze_requests(backend="fused")`` of a screen-sized batch through
   ``segment_replay`` against the exact replay.
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
   SSD kernels in f32) give their times.  Then ``serve_cli``: the two
   serving entry points, ``repro_torch.launch.serve`` and
   ``repro_torch.examples.serve_lm``, with ``--arch zamba2-1.2b`` at their
   defaults, and ``launch.serve --arch mamba2-370m``; each must answer
   every request.
   Then ``profile`` (not gated): the timed ``ops.ssd_forward`` call at the
   ``mamba2-370m`` SSD layer's shape once more, under ``torch.profiler``:
   the device time of its kernels, the device's idle share over its
   host-issued wall, and kernel launches and device time split between
   the chunk kernel, the state pass (``recurrence_launches``; its route
   and kernels) and the rest of the eager glue.
5. ``kernels``: every kernel (the state pass's three apart) with its
   launches on the paths, the loop and the serve phases, its numbers
   summed over one pass of each path, of each realized loop candidate
   (``loop#1``, ``loop#2``) and of each serve phase (``serve``,
   ``serve:mamba2-370m``), and each one's share apart (both bounds,
   ``arith``); under
   ``bf16`` the realization launches' sums with bf16 operands.  The cost
   model's two kernels carry their launches in the ``fused`` phase and
   one launch's numbers at that phase's shape.

Then the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero without that line; without a card, or outside a checkout,
it exits non-zero before printing anything.
"""

from __future__ import annotations

import contextlib
import json
import re
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
ARITH = {"tiled_matmul": "3xTF32 mma.sync",
         "flash_attention_mha": "3xTF32 mma.sync",
         "ssd_chunk_dual": "3xTF32 mma.sync",
         "ssd_state_walk": "3xTF32 mma.sync",
         "ssd_state_scan": "f32 FMA (no tensor cores)",
         "ssd_state_out": "3xTF32 mma.sync"}
# the state pass's kernels, by route (repro_torch.kernels.ssd_state)
STATE_KERNELS = ("ssd_state_walk", "ssd_state_scan", "ssd_state_out")
# the kernel functions of ssd_state.cu whose SASS must hold HMMA: the
# two that take the product C . h (the scan takes none); every function
# of _build.TENSOR_CORE_SOURCES must too, none of fused_eval.cu
STATE_HMMA_KERNELS = ("ssd_state_walk", "ssd_state_out")
ARITH_BF16 = {
    "tiled_matmul": "bf16 operands, f32 math: 1 TF32 mma.sync a product",
    "flash_attention_mha": "bf16 operands, f32 math: 1 TF32 mma.sync for "
                           "QK^T, 2 for PV (P split)",
    "ssd_chunk_dual": "bf16 inputs, f32 math and outputs: 1 TF32 mma.sync "
                      "for CB^T, 2 for Wx and (dB)^T x"}

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
           (2048, 512, 2048, True)]
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
              (1, 2, 64, 96, 64, True, True)]
# (BC, Q, H, P, N, x one float into its storage): the mamba2-370m path's
# shape; tests/test_kernels.py's three; ragged chunk lengths; P of 32 and
# 64; two P tiles with N off 4; then, each at an odd number of (chunk,
# head) blocks: 4-byte copies (x not 16-byte aligned), Q of 70 and 100,
# N % 8 != 0 and P = 130
SSD_PATH = [(32, 128, 16, 128, 64, False)]
# the N <= 128 instance (P64 N128), timed: the mamba2-370m serve wave's
# shape (4 slots of up to 1024 tokens) and an odd N past 64 (4-byte
# copies); then edges: N = 100 with 16-byte copies, x a float off 16 B, P
# = 130 in three tiles, Q off 16
SSD_WIDE = [(32, 128, 32, 64, 128, False), (32, 128, 32, 64, 99, False)]
SSD_WIDE_EDGE = [(2, 128, 3, 64, 100, False), (1, 100, 5, 64, 128, True),
                 (1, 128, 3, 130, 72, False), (3, 70, 3, 64, 99, False)]
SSD_EDGE = [(2, 16, 2, 8, 4, False), (4, 64, 4, 32, 16, False),
            (1, 128, 8, 64, 32, False), (2, 96, 4, 64, 64, False),
            (3, 70, 2, 32, 16, False), (2, 70, 3, 130, 50, False),
            (3, 70, 3, 64, 16, True), (1, 100, 5, 64, 64, False),
            (3, 100, 1, 32, 12, False), (1, 128, 3, 130, 20, False),
            (1, 70, 7, 60, 50, True)]
# bf16 at ragged sizes, each taking the one-element (ld2) copies: odd K,
# odd N; D = 40 (16-byte copies, a head dim off the template) and D = 33;
# P = 130 and N % 8 != 0
MM_BF16_EDGE = [(257, 129, 65), (2048, 131, 2048), (1000, 64, 77)]
FLASH_BF16_EDGE = [(2, 2, 100, 70, 40, True), (1, 2, 70, 70, 33, True)]
SSD_BF16_EDGE = [(1, 128, 3, 130, 24), (2, 16, 2, 8, 4),
                 (2, 128, 3, 64, 100), (1, 100, 5, 130, 128)]
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
# the cost model's kernels: the fused phase's SA (replica exchange on the
# granite graph, S-Arch, the fixtures' batch), its lockstep batch (one
# proposal a chain) and a screen-sized batch; the layouts of the kernel
# lines (the reference's fused-pass test arch with moe-quick, and S-Arch
# with granite); the reference's tolerances (tests/test_fused_eval.py:
# rel 1e-4 for the fused pass, rtol 2e-4 / atol 1e-2 for the replay)
FUSED_SPEC = "lm:granite-moe-3b-a800m:seq=4096,n_layers=2"
FUSED_TOTAL_BATCH = 4
FUSED_CHAINS = 4
FUSED_ITERS = 200
FUSED_B = (FUSED_CHAINS, 64)
ZOO_ARCH = dict(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=16.0,
                d2d_bw=8.0, dram_bw=64.0, glb_kb=512, macs_per_core=256)
FUSED_REL_TOL = 1e-4
REPLAY_TOL = {"rtol": 2e-4, "atol": 1e-2}
COST_KERNEL_FILES = {
    "fused_eval": ("src/repro_torch/kernels/csrc/fused_eval.cu",
                   "src/repro/core/evaluator.py:97"),
    "segment_replay": ("src/repro_torch/kernels/csrc/fused_eval.cu",
                       "src/repro/core/analyzer.py:60"),
}
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


def on_card(randn, shape, offset: bool):
    """randn of ``shape``, contiguous; with ``offset`` a view one float into
    its storage (data pointer 4- but not 16-byte aligned)."""
    n = 1
    for d in shape:
        n *= d
    return randn(n + int(offset))[int(offset):].view(*shape)


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
                "max_abs_err": (got - want).abs().max().item()}
        if path:
            line.update(bounds(*launch_cost("tiled_matmul",
                                            {"M": M, "K": K, "N": N})))
            line["ms"] = time_ms(lambda: tiled_matmul(a, b))
            line["host_issued_ms"] = time_ms(lambda: tiled_matmul(a, b),
                                             device=False)
            line["plain_ms"] = time_ms(lambda: ref.matmul_ref(a, b))
            line["library_ms"] = time_ms(lambda: torch.matmul(a, b))
            timed[("tiled_matmul", (M, K, N))] = line
        emit(line)
        if not torch.allclose(got, want, **MM_TOL):
            raise AssertionError(f"tiled_matmul disagrees at {(M, K, N)}")
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
                **FLASH_TOL, "max_abs_err": (got - want).abs().max().item()}
        if path:
            shape = {**line["shape"], "causal": int(causal)}
            line.update(bounds(*launch_cost("flash_attention_mha", shape)))
            line["ms"] = time_ms(
                lambda: flash_attention_mha(q, k, v, causal=causal))
            line["host_issued_ms"] = time_ms(
                lambda: flash_attention_mha(q, k, v, causal=causal),
                device=False)
            line["plain_ms"] = time_ms(
                lambda: ref.attention_ref(q, k, v, causal=causal))
            line["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal))
            timed[("flash_attention_mha", tuple(shape.values()))] = line
        emit(line)
        if not torch.allclose(got, want, **FLASH_TOL):
            raise AssertionError(
                f"flash_attention_mha disagrees at {(B, H, Sq, Sk, D)}")
    for path, clock, (BC, Q, H, P, N, offset) in \
            [(True, True, s) for s in SSD_PATH] \
            + [(False, True, s) for s in SSD_WIDE] \
            + [(False, False, s) for s in SSD_EDGE + SSD_WIDE_EDGE]:
        x = on_card(randn, (BC, Q, H, P), offset)
        cum = torch.cumsum(-randn(BC, Q, H).abs() * 0.1, dim=1)
        Bm, Cm = randn(BC, Q, N), randn(BC, Q, N)
        got = ssd_chunk_dual(x, cum, Bm, Cm)
        want = ref.ssd_chunk_ref(x, cum, Bm, Cm)
        torch.cuda.synchronize()
        shape = {"BC": BC, "Q": Q, "H": H, "P": P, "N": N}
        line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                "shape": shape, "x_offset": int(offset),
                "route": mamba_ssd.kernel_route(x, Bm, Cm),
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
    call must launch the kernel (its count moves by one) and return the
    reference's output type (bf16 for GEMM and flash, f32 for SSD).  The
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
        n0 = fn.launches
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        if fn.launches != n0 + 1:
            raise AssertionError(f"{kernel} bf16: the launch was not "
                                 f"counted ({n0} -> {fn.launches})")
        return out

    def finish(line, kernel, key, path, err, ok, timings, clock=False):
        """``path``: timed and kept for the per-pass summary; ``clock``:
        timed only."""
        line["max_abs_err"] = err
        if path or clock:
            line.update(bf16_bounds(kernel, line["shape"]))
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
        got = run(tiled_matmul, "tiled_matmul", a, b)
        want = ref.matmul_ref(a.float(), b.float())
        line = {"phase": "kernel", "kernel": "tiled_matmul", "dtype": "bf16",
                "shape": {"M": M, "K": K, "N": N},
                "route": mm.kernel_route(a, b),
                "arith": ARITH_BF16["tiled_matmul"], "main_path": path,
                "out_dtype": str(got.dtype), **MM_BF16_TOL}
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
        got = run(flash_attention_mha, "flash_attention_mha", q, k, v,
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
                **FLASH_BF16_TOL}
        finish(line, "flash_attention_mha", tuple(shape.values()), path,
               (got.float() - want).abs().max().item(),
               got.dtype == torch.bfloat16
               and torch.allclose(got.float(), want, **FLASH_BF16_TOL),
               {"ms": lambda: flash_attention_mha(q, k, v, causal=causal),
                "plain_ms": lambda: ref.attention_ref(q, k, v,
                                                      causal=causal),
                "library_ms": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)})
    for path, clock, (BC, Q, H, P, N) in \
            [(True, True, s[:5]) for s in SSD_PATH] \
            + [(False, True, s[:5]) for s in SSD_WIDE[:1]] \
            + [(False, False, s) for s in SSD_BF16_EDGE]:
        x = randn(BC, Q, H, P)
        cum = torch.cumsum(-randn(BC, Q, H).float().abs() * 0.1,
                           dim=1).bfloat16()
        Bm, Cm = randn(BC, Q, N), randn(BC, Q, N)
        got = run(ssd_chunk_dual, "ssd_chunk_dual", x, cum, Bm, Cm)
        want = ref.ssd_chunk_ref(x.float(), cum.float(), Bm.float(),
                                 Cm.float())
        shape = {"BC": BC, "Q": Q, "H": H, "P": P, "N": N}
        line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                "dtype": "bf16", "shape": shape,
                "route": mamba_ssd.kernel_route(x, Bm, Cm),
                "arith": ARITH_BF16["ssd_chunk_dual"], "main_path": path,
                "out_dtype": str(got[0].dtype), **SSD_BF16_TOL}
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
        t0 = time.perf_counter()
        realize_main(argv)                          # the counted pass
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    rec = last_record()
    stages = rec["stages"]
    if len(stages) != n_stages or launches != want_launches:
        raise AssertionError(f"path {name} ran {len(stages)} stages with "
                             f"launches {launches}")
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
                         s["pred_d2d_bytes"]] for s in stages],
          "per_stage_columns": ["stage", "wall_ms", "flops", "dci_bytes",
                                "pred_flops", "pred_d2d_bytes"],
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


def cost_wrappers() -> dict:
    """The cost model's kernel wrappers, by kernel name."""
    from repro_torch.kernels.fused_eval import fused_eval, segment_replay
    return {"fused_eval": fused_eval, "segment_replay": segment_replay}


def cost_layouts() -> list:
    """(name, arch, graph) of the cost kernels' lines: the reference's
    fused-pass test arch (4x3 cores, two chiplets) with ``moe-quick``, and
    S-Arch with the granite graph of the fused phase."""
    from repro_torch.core.hw import ArchConfig, simba_arch
    from repro_torch.core.workloads import make_workload
    return [("zoo:moe-quick", ArchConfig(**ZOO_ARCH),
             make_workload("moe-quick")),
            ("granite", simba_arch(), make_workload(FUSED_SPEC))]


def cost_requests(arch, g, n: int, seed: int) -> list:
    """``n`` (group, random LMS) requests over the graph's partition, as a
    lockstep iteration or a screen hands them to the evaluator."""
    import numpy as np

    from repro_torch.core.encoding import random_lms
    from repro_torch.core.graph_partition import partition_graph
    rng = np.random.default_rng(seed)
    groups = partition_graph(g, arch, FUSED_TOTAL_BATCH)
    return [(grp, random_lms(grp, g, arch.n_cores, arch.n_dram, rng))
            for grp in (groups[int(i)]
                        for i in rng.integers(len(groups), size=n))]


def _bound(flops: float, peak: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_bytes": nbytes, "bound_ops": flops}


def check_cost_kernels(dev) -> dict:
    """``fused_eval`` and ``segment_replay`` at the batch sizes of a
    lockstep SA iteration and of a screen, on both layouts.  ``fused_eval``
    is held against its plain version on the same inputs on the card and
    against the exact numpy engine (rel 1e-4, equal bottleneck);
    ``segment_replay`` against ``np.bincount`` on the same stream
    (rtol 2e-4 / atol 1e-2; it adds in float64).  Each line has the
    kernel's device time, the plain version's, the kernel's as the host
    issues it, the library call's (``index_add_`` for the replay; no
    PyTorch call computes the fused pass), the bound (the stream read
    once, the outputs written once, at the HBM rate) and the host time of
    one whole batch evaluation each way (``eval_batch_ms``: numpy against
    fused, streams and caches warm).  Returns the lines by (kernel,
    layout, B)."""
    import numpy as np
    import torch

    from repro_torch.core.evaluator import Evaluator
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_eval import fused_eval, segment_replay

    names = ("compute", "noc", "d2d", "dram")
    timed = {}
    for layout, arch, g in cost_layouts():
        for B in FUSED_B:
            reqs = cost_requests(arch, g, B, seed=B)
            ev = Evaluator(arch, g, fused_device=dev)
            exact = ev.eval_requests_batch(reqs, FUSED_TOTAL_BATCH)
            plan = ev.fused_plan()
            host = ev._fused_inputs(reqs, FUSED_TOTAL_BATCH)
            args = [torch.from_numpy(a).to(dev) for a in host]
            kw = dict(spans=plan.spans, d2d_mask=plan.d2d_mask,
                      consts=plan.consts, has_d2d=plan.has_d2d,
                      buf_len=plan.buf_len)
            out, bn = fused_eval(plan, *args)
            want, wbn = ref.fused_eval_ref(*args, **kw)
            torch.cuda.synchronize()
            scale = want.abs().clamp_min(1e-30)
            rel_plain = ((out - want).abs() / scale).max().item()
            got = out.cpu().numpy()
            bn_host = bn.cpu().numpy()
            rel_exact = max(
                max(abs(float(got[r, b]) - v) / abs(v) for r, v in
                    ((0, ge.delay_s), (1, ge.energy_j), (2, ge.stage_time_s)))
                for b, (ge, _) in enumerate(exact))
            same_bn = all(names[int(bn_host[b])] == ge.bottleneck
                          for b, (ge, _) in enumerate(exact))
            nbytes = sum(a.nbytes for a in host) + out.numel() * 4 + B * 4
            line = {"phase": "kernel", "kernel": "fused_eval",
                    "layout": layout, "arch": arch.label(), "B": B,
                    "buf_len": plan.buf_len, "stream": int(host[0].size),
                    "main_path": (layout, B) == ("granite", FUSED_CHAINS),
                    "rel_tol": FUSED_REL_TOL,
                    "max_abs_err": (out - want).abs().max().item(),
                    "max_rel_err_vs_plain": rel_plain,
                    "max_rel_err_vs_exact": rel_exact,
                    "bottleneck_equal": same_bn,
                    **_bound(host[0].size + 2 * B * plan.buf_len,
                             PEAK_F32_FLOPS, nbytes),
                    "ms": time_ms(lambda: fused_eval(plan, *args)),
                    "host_issued_ms": time_ms(lambda: fused_eval(plan, *args),
                                              device=False),
                    "plain_ms": time_ms(
                        lambda: ref.fused_eval_ref(*args, **kw)),
                    "library_ms": None,
                    "library": "none: no single PyTorch call computes it"}
            line["eval_batch_ms"] = {
                be: host_ms(lambda: ev.eval_requests_batch(
                    reqs, FUSED_TOTAL_BATCH, backend=be))
                for be in ("numpy", "fused")}
            timed[("fused_eval", layout, B)] = line
            emit(line)
            if not (rel_plain <= FUSED_REL_TOL and torch.equal(bn, wbn)
                    and rel_exact <= FUSED_REL_TOL and same_bn):
                raise AssertionError(f"fused_eval disagrees at {layout} "
                                     f"B={B}: {rel_plain}, {rel_exact}, "
                                     f"bottleneck {same_bn}")

            idx, vals, _ = ev.analyzer._request_streams(reqs,
                                                        FUSED_TOTAL_BATCH)
            n_cells = B * ev.analyzer._buf_len
            ti, tv = torch.from_numpy(idx).to(dev), torch.from_numpy(
                vals).to(dev)
            got = segment_replay(ti, tv, n_cells)
            torch.cuda.synchronize()
            want = np.bincount(idx, weights=vals, minlength=n_cells)
            diff = np.abs(got.cpu().numpy() - want)
            line = {"phase": "kernel", "kernel": "segment_replay",
                    "layout": layout, "arch": arch.label(), "B": B,
                    "cells": n_cells, "stream": int(idx.size),
                    "main_path": (layout, B) == ("granite", FUSED_B[1]),
                    **REPLAY_TOL, "max_abs_err": float(diff.max()),
                    "max_rel_err": float((diff / np.maximum(
                        np.abs(want), 1e-300))[want != 0].max()),
                    **_bound(idx.size, PEAK_F64_FLOPS,
                             idx.nbytes + vals.nbytes + n_cells * 8),
                    "ms": time_ms(lambda: segment_replay(ti, tv, n_cells)),
                    "host_issued_ms": time_ms(
                        lambda: segment_replay(ti, tv, n_cells),
                        device=False),
                    "plain_ms": time_ms(
                        lambda: ref.segment_replay_ref(ti, tv, n_cells)),
                    "library_ms": time_ms(
                        lambda: torch.zeros(n_cells, dtype=tv.dtype,
                                            device=dev).index_add_(0, ti, tv)),
                    "library": "torch.Tensor.index_add_"}
            timed[("segment_replay", layout, B)] = line
            emit(line)
            if not np.allclose(got.cpu().numpy(), want, **REPLAY_TOL):
                raise AssertionError(f"segment_replay disagrees at "
                                     f"{layout} B={B}")
    return timed


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
    batch against the exact replay (rtol 2e-4 / atol 1e-2).  Fails unless
    both kernels launched."""
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
              "weight_totals_equal": bool(np.array_equal(
                  fused.weight_totals, exact.weight_totals))}
    if not (np.allclose(fused.buf, exact.buf, **REPLAY_TOL)
            and replay["weight_totals_equal"]):
        raise AssertionError(f"fused replay disagrees: {replay}")
    if not all(launches.values()):
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


def cost_kernel_summary(cost_timed: dict, launches: dict) -> list:
    """The ``kernels`` entries of the cost model's kernels: ``launches``
    from the fused phase, the other numbers from the kernel line at the
    phase's shape (granite layout; the lockstep batch for ``fused_eval``,
    the screen batch the phase replays for ``segment_replay``), one
    launch; ``max_abs_err`` over all of the kernel's lines."""
    out = []
    for name, (source, replaces) in COST_KERNEL_FILES.items():
        lines = [ln for (k, _, _), ln in cost_timed.items() if k == name]
        main, = [ln for ln in lines if ln["main_path"]]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
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


def serve_kernel_lines(dev, arch, waves) -> dict:
    """Kernel lines at a serve phase's launch shapes, one set per wave (B
    slots, prompts padded to L), by ``SERVE_ARCHS[arch]``: flash on bf16
    (B, heads, L, L, head dim), causal, as the prefill runs it, where the
    arch has attention; the SSD chunk kernel on f32 (B * ceil(L / 128),
    128, H, P, N); the state pass on (B, ceil(L / 128), 128, H, P, N, G =
    1) by the route the rule picks.  Each against its plain version on the
    same inputs (flash on the upcast inputs, 2e-2; the SSD kernels 1e-4),
    with its device time, the plain version's, the library call's (bf16
    ``scaled_dot_product_attention``; none for the SSD kernels) and the
    bound (bf16 rates for flash).  Returns them by launch key."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, mamba_ssd, ref
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.realize.measure import launch_cost

    n_flash, _, heads, hd, H, P, N = SERVE_ARCHS[arch]
    main_path = serve_path(arch)
    gen = torch.Generator(device=dev).manual_seed(2)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    timed = {}
    for B, L in sorted(set(waves)):
        nc = -(-L // 128)
        if n_flash:
            q, k, v = (randn(B, heads, L, hd).bfloat16() for _ in range(3))
            got = flash_attention_mha(q, k, v, causal=True)
            want = ref.attention_ref(q.float(), k.float(), v.float(),
                                     causal=True)
            torch.cuda.synchronize()
            shape = {"B": B, "H": heads, "Sq": L, "Sk": L, "D": hd,
                     "causal": 1}
            line = {"phase": "kernel", "kernel": "flash_attention_mha",
                    "dtype": "bf16", "shape": shape, "q_offset": 0,
                    "route": flash_attention.kernel_route(q, k, v),
                    "arith": ARITH_BF16["flash_attention_mha"],
                    "main_path": main_path, **FLASH_BF16_TOL,
                    "max_abs_err": (got.float() - want).abs().max().item(),
                    **bf16_bounds("flash_attention_mha", shape)}
            line["bound_3xtf32_ms"] = line["bound_ms"]   # bf16 operands
            line["ms"] = time_ms(lambda: flash_attention_mha(q, k, v))
            line["host_issued_ms"] = time_ms(
                lambda: flash_attention_mha(q, k, v), device=False)
            line["plain_ms"] = time_ms(lambda: ref.attention_ref(q, k, v))
            line["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True))
            emit(line)
            if not torch.allclose(got.float(), want, **FLASH_BF16_TOL):
                raise AssertionError(f"serve flash disagrees at {shape}")
            timed[("flash_attention_mha",
                   (B, heads, L, L, hd, 1, 0, "bf16"))] = line
            del q, k, v, got, want

        x = randn(B * nc, 128, H, P)
        cum = torch.cumsum(-randn(B * nc, 128, H).abs() * 0.1, dim=1)
        Bm, Cm = randn(B * nc, 128, N), randn(B * nc, 128, N)
        got = ssd_chunk_dual(x, cum, Bm, Cm)
        want = ref.ssd_chunk_ref(x, cum, Bm, Cm)
        torch.cuda.synchronize()
        shape = {"BC": B * nc, "Q": 128, "H": H, "P": P, "N": N}
        line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                "shape": shape, "route": mamba_ssd.kernel_route(x, Bm, Cm),
                "arith": ARITH["ssd_chunk_dual"], "main_path": main_path,
                **SSD_TOL, "max_abs_err": max((g - w).abs().max().item()
                                              for g, w in zip(got, want)),
                **bounds(*launch_cost("ssd_chunk_dual", shape))}
        line["ms"] = time_ms(lambda: ssd_chunk_dual(x, cum, Bm, Cm))
        line["host_issued_ms"] = time_ms(
            lambda: ssd_chunk_dual(x, cum, Bm, Cm), device=False)
        line["plain_ms"] = time_ms(lambda: ref.ssd_chunk_ref(x, cum, Bm, Cm))
        line["library_ms"] = None
        line["library"] = "none: no single PyTorch call computes it"
        emit(line)
        if not all(torch.allclose(g, w, **SSD_TOL)
                   for g, w in zip(got, want)):
            raise AssertionError(f"serve ssd_chunk_dual disagrees at {shape}")
        timed[("ssd_chunk_dual", tuple(shape.values()))] = line
        del x, cum, Bm, Cm, got, want
        state = (B, nc, 128, H, P, N, 1)
        for kernel, line in check_state_pass(
                randn, *state, False, timed=True,
                main_path=main_path).items():
            timed[(kernel, state)] = line
    return timed


def serve_path(arch: str) -> str:
    """The name of a serve phase in the per-pass summary: ``serve`` for
    zamba2-1.2b (as before mamba2-370m served), ``serve:<arch>`` else."""
    return "serve" if arch == SERVE_ARCH else f"serve:{arch}"


def serve_check(cfg, params, toks, dev) -> dict:
    """The first wave's prefill and ``SERVE_CHECK_STEPS`` decode steps
    four ways on the card, each on its own cache and all fed the greedy
    tokens of the first: through the kernels and with
    ``use_kernels=False``, in the config's bf16 compute and in f32 compute
    (the same parameters).  Per step, the largest difference relative to
    the largest logit of: kernels against plain in f32 (the kernels'
    error: gated at ``SERVE_TOL``); kernels against plain in bf16; and
    the plain route's bf16 against its f32 (the bf16 rounding the served
    numerics carry, which a 38-layer random-init model amplifies: the
    bf16 gap is gated at the larger of ``SERVE_TOL`` and that)."""
    import torch

    from repro_torch.models import model_api
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    feed, logits = None, {}
    for cdt in ("bfloat16", "float32"):
        api = model_api(cfg.replace(compute_dtype=cdt))
        for uk in (True, False):
            cache = api.init_cache(toks.shape[0], SERVE_MAX_SEQ, device=dev)
            lg, cache = api.prefill(params, {"tokens": toks}, cache,
                                    use_kernels=uk)
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
        "rel_tol": SERVE_TOL, "slots": int(toks.shape[0]),
        "max_rel_err": max(line["f32_kernels_vs_plain"]),
        "bf16_within_rounding": all(
            e <= b for e, b in zip(line["bf16_kernels_vs_plain"],
                                   bf16_bound)),
        "greedy_tokens_equal_bf16": [
            int((a.argmax(-1) == b.argmax(-1)).sum().item()) for a, b in
            zip(logits[("bfloat16", True)], logits[("bfloat16", False)])],
        "steps": "prefill, then teacher-forced decode steps"})
    return line


def run_serve(dev, arch):
    """A ``serve`` phase (``SERVE_*``): ``arch`` at full width and depth
    from the port's seeded ``init_params`` on the card, a ``Server``
    answering ``SERVE_REQUESTS`` requests, after one short warm-up wave
    (library handles, the allocator), with the launch counts set to 0 just
    before the counted run.  Gates: every request answered, the launches a
    wave by ``SERVE_ARCHS`` (the state pass's by the route it takes at the
    wave's shape), the kernel route within ``SERVE_TOL`` of the plain
    route.  Returns the line, the (B, L) of each wave and the launch keys
    of the run."""
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
    n_flash, n_ssm, heads, hd, H, P, N = SERVE_ARCHS[arch]
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
    keys, routes = [], []
    for B, L in shapes:
        nc = -(-L // 128)
        state = (B, nc, 128, H, P, N, 1)
        kernels = ssd_state.route_kernels(B, H, P, N, dev)
        routes.append(ssd_state.state_route(B, H, P, N,
                                            ssd_state.sm_count(dev)))
        keys += [("flash_attention_mha",
                  (B, heads, L, L, hd, 1, 0, "bf16"))] * n_flash \
            + [("ssd_chunk_dual", (B * nc, 128, H, P, N))] * n_ssm \
            + [(k, state) for k in kernels] * n_ssm
    want = {k: sum(1 for key in keys if key[0] == k) for k in wrappers}
    n_tok = sum(len(r.tokens) for r in results)
    steps = [t for c in costs for t in c.step_s]
    check = serve_check(cfg, params, torch.from_numpy(
        srv.executor._pad_wave(waves[0])).to(dev), dev)
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
    if len(results) != SERVE_REQUESTS \
            or sorted(r.rid for r in results) != list(range(SERVE_REQUESTS)) \
            or not all(len(r.tokens) for r in results):
        raise AssertionError(f"serve: answered {len(results)} requests")
    if launches != want:
        raise AssertionError(f"serve launched {launches}, not {want}")
    if check["max_rel_err"] > SERVE_TOL or not check["bf16_within_rounding"]:
        raise AssertionError(f"serve: the kernel route against the plain "
                             f"route: {check}")
    line["seconds_phase"] = time.perf_counter() - t_phase
    return line, shapes, keys


def run_serve_cli() -> dict:
    """``python -m repro_torch.launch.serve --arch zamba2-1.2b`` and
    ``python -m repro_torch.examples.serve_lm --arch zamba2-1.2b`` in this
    process (their defaults: 8 requests of 4-31 prompt tokens, a
    512-position cache; 10 of 4-47, 256), then ``launch.serve --arch
    mamba2-370m``: each serves at full width on the card and answers every
    request."""
    import io

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
    hmma = {name: _build.hmma_counts(name) for name in _build.SOURCES}
    if None in hmma.values():
        emit({"phase": "sass", "HMMA": None,
              "note": "the toolkit has no cuobjdump"})
    else:
        gated = {name: list(hmma[name])
                 for name in _build.TENSOR_CORE_SOURCES}
        gated["ssd_state"] = [fn for fn in hmma["ssd_state"]
                              if any(k in fn for k in STATE_HMMA_KERNELS)]
        emit({"phase": "sass", "HMMA": hmma,
              "gated": {**{name: "every kernel function"
                           for name in _build.TENSOR_CORE_SOURCES},
                        "ssd_state": list(STATE_HMMA_KERNELS)}})
        for name, fns in gated.items():
            named = STATE_HMMA_KERNELS if name == "ssd_state" else ()
            if not fns or any(hmma[name][fn] == 0 for fn in fns) \
                    or not all(any(k in fn for fn in fns) for k in named):
                raise AssertionError(f"{name}: a kernel without tensor-core "
                                     f"instructions: {hmma[name]}")

    timed, layer = check_kernels(dev)
    timed_bf16 = check_bf16(dev)
    runs = {path[0]: run_path(path, dev) for path in PATHS}
    loop_line, loop_runs = run_loop(dev, timed)
    emit(loop_line)
    runs.update(loop_runs)
    runs = {k: (launches, program_keys(prog))
            for k, (launches, prog) in runs.items()}
    cost_timed = check_cost_kernels(dev)
    fused_line = run_fused(dev)
    emit(fused_line)
    for arch in SERVE_ARCHS:
        serve_line, serve_waves, serve_keys = run_serve(dev, arch)
        emit(serve_line)
        torch.cuda.empty_cache()
        timed.update(serve_kernel_lines(dev, arch, serve_waves))
        runs[serve_path(arch)] = (serve_line["launches"], serve_keys)
    emit(run_serve_cli())
    torch.cuda.empty_cache()
    emit(profile_ssd_forward(*layer))
    emit({"kernels": per_pass_summary(timed, timed_bf16, runs)
          + cost_kernel_summary(cost_timed, fused_line["launches"])})
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
