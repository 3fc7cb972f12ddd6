#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of JAX
or of the JAX package.  It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the six CUDA sources from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/``, one ``nvcc`` per source, all started together, and
   prints what ``ptxas`` reports; counts instructions in the SASS
   (``cuobjdump``, per function): every function of flash_attention's
   library but its split pre-pass must hold HGMMA (wgmma) and UTMALDG
   (TMA loads), ssd_scan's HMMA (mma.sync) and neither of those,
   topk_reduce's no float atomic and no compare-and-swap on global
   memory;
3. kernel phase: holds every kernel bitwise against its plain PyTorch
   version on the card, with one all-zero row each: the int8 kernels at
   the main path's shape (8, 2120) and at (8, 2**24 + 77) with a ragged
   tail, block 256; the sign kernels at (8, 2120) and (8, 2**24 + 77)
   with block 1024 and at (8, 2120) with blocks 64, 1000 and 24 (no power
   of two, and 24/8 bytes no multiple of 4), with -0.0 entries that must
   pack as + and a padded tail whose bits must be 1; times kernel and
   plain version with CUDA events (median of >= 20 runs after warm-up)
   beside the bound (bytes moved / 3.35 TB/s);
4. main path phase: runs the quickstart world (two_level n=8 N=2 G=16
   I=4, MLP 24-32-8, sgd(0.08), batch 10, T=96) through
   ``HSGD.run_rounds`` on ``cuda`` with ``comms="int8"`` (wire path),
   ``Comms("int8", wire_reduce=False)`` (legacy roundtrip),
   ``comms="sign"`` and ``Comms("sign", wire_reduce=False)``, then the
   three-level ``HierarchySpec((2, 2, 2), (8, 4, 2))`` with
   ``comms="sign"`` and the two-level world with ``comms="sign"`` and
   ``momentum(0.02)``, counting kernel launches from zero for each run;
   requires every kernel of the run to have launched, the same
   trajectory bit for bit as the same run with the plain versions on the
   card, the wire bytes of the same run on the CPU and of the JAX
   package's run, and a final loss within LOSS_RTOL relative of the CPU
   run;
   the int8 runs must also reach accuracy >= 0.9 (the sign codec keeps
   this model at chance by design, so its runs have no accuracy floor);
4a. top-k kernel phase: holds ``topk_decode_reduce`` against its plain
   version (``topk_reduce_ref``) on the card at TOPK_CASES: bit for bit,
   and equal to itself on a second call, where each member's indices are
   distinct (the quickstart's syncs at rates 0.25 and 1/16, the smallest
   payload, a zeroed member, the timing shape, a size just above one of
   the kernel's tiles, one that is no multiple of it, indices out of range
   and K = 0); to 1e-6 where they repeat;
   times kernel, plain version and one ``index_add_`` of all entries (the
   library yardstick, which the port never calls) at TOPK_TIMED beside
   the bound, with the device time of each of the kernel's stages
   (``torch.profiler``);
4b. sim top-k phase: the quickstart world with ``Comms("topk",
   rate=0.25)``, wire path and legacy roundtrip, on the card and the CPU:
   the JAX package's wire bytes, the CPU run's loss within LOSS_RTOL, no
   kernel launch (sim's top-k reduce is the dense group mean);
4c. mesh phase: ``launch(mesh_rank, 8, backend="gloo", device="cuda")``,
   eight processes on the one card, each the quickstart world through
   ``MeshExecutor`` with its launch counts from zero for each run:
   ``exact=True`` with comms off, int8, sign and top-k must equal the
   card's sim bit for bit (params, residuals, loss); production top-k on
   the two-level and the three-level ``((2, 2, 2), (8, 4, 2))`` worlds
   must launch ``topk_decode_reduce`` exactly once per sync on every rank
   (24 and 48) and stay within MESH_ATOL of the sim's params and
   LOSS_RTOL of its loss; production int8 must launch
   ``int8_scale_quantize`` on every rank and stay within MESH_ATOL and
   LOSS_RTOL too; on shared inputs in every rank, one int8 sync through
   the production lowering must equal the exact one bit for bit, and a
   top-k sync to 1e-6; a worker's update over its one row must equal its
   row of the sim's batch of 8 bit for bit (the model's dense layers are a
   product and a sum, not a batched cuBLAS matmul), and the sim's steps/s
   under that form must keep DENSE_FORM_MIN_RATIO of the matmul form's,
   timed in turns in this phase; prints wall seconds and steps/s of mesh
   and sim;
5. attention kernel phase: holds ``flash_attention`` against its plain
   version (``attention_ref``) on the card at ATTN_CASES, to the
   reference's tolerances (2e-5 in float32, 2e-2 in bfloat16), and times
   kernel, plain version and one ``scaled_dot_product_attention`` call of
   the same function (the library yardstick, which the port never calls;
   a boolean mask for the window) at the qwen2 prefill shape (a), the
   gemma3 local-layer shape (b) and recurrentgemma-2b's attention (c),
   beside the bounds at 4*D, 6*D and 8*D tensor-core operations per pair
   (the function's, a two-term and the kernel's three-term split of P);
   (a), (b) and (c) also in float32, on inputs drawn in float32, beside
   one float32 call, the float32 ceiling (4*D operations at the CUDA
   cores' float32 rate) and the kernel's bound (the split pre-pass's
   bytes, then 24*D tensor-core operations for its exact splits), with
   the device time of the pre-pass and of the attention launch; every
   float32 case also against the same attention in float64, within
   ATTN_F32_ULPS x 2^-24 of max |o|, a limit that the design without its
   lo planes must miss;
6. serving phase: qwen2-0.5b at full width (24 layers, d_model 896) with
   ``use_kernels=True``, random weights from a seeded generator, through
   ``DecodeEngine.generate``: 8 requests, prompts of 1024 random tokens,
   32 greedy tokens, launches counted from zero (one ``flash_attention``
   per layer per prefill: 24).  In float32 the tokens must equal those of
   the same run with the plain versions on the card, and the prefill
   logits must agree to PREFILL_RTOL * max|logit|; in bfloat16 (the
   config's own) ``score_continuation`` of the generated tokens under both
   routes must agree to SCORE_ATOL, and every log-probability must be
   finite.  Then reduced gemma3-12b (a local layer with window 16 and a
   global one), float32, prompt 40 > window: identical tokens under both
   routes and one launch on each layer kind;
7. SSM kernel phase: holds ``ssd_scan`` (float32 and bfloat16) and
   ``rglru_scan`` against their plain versions (``ssd_ref``,
   ``rglru_ref``) on the card at the reference's sweep shapes, the largest
   SSD state the kernel takes, a strided SSD input (column slices of one
   projection, which must give the contiguous inputs' result bit for bit),
   the full-width shapes of mamba2-130m's and recurrentgemma-2b's
   forward (8 x 1024) and, for SSD, the edges of its chunk-parallel passes
   (S = 1025, S < chunk, chunk 32, odd P and N), to the reference's
   limits (SSD: max |diff| / max |plain| < 1e-4 in float32, 3e-2 in
   bfloat16; RG-LRU: atol 5e-5, rtol 1e-4), and times kernel and plain
   version at the full-width
   shapes, SSD with the device time of each of its four launches
   (``torch.profiler``) and the bound of its design (the scratch traffic
   of its passes added to the function's bytes) beside the function's;
8. SSM forward phase: ``DecoderLM.loss`` of mamba2-130m and
   recurrentgemma-2b at full width with ``use_kernels=True``, random
   weights from a seeded generator, 8 sequences of 1024 random tokens
   (targets shifted by one), under ``torch.inference_mode()``, in float32
   and bfloat16, launches counted from zero: exactly 24 ``ssd_scan``
   (mamba2-130m), and 18 ``rglru_scan`` plus 8 ``flash_attention``
   (recurrentgemma-2b).  Held against the same call with the plain
   versions on the card: float32 logits within PREFILL_RTOL of the largest
   and CE within CE_RTOL relative, bfloat16 CE within CE_ATOL_BF16;
   prints tokens/s (the median of LOSS_REPS calls after a warm-up call at
   the same shape) and peak memory;
9. SSM serving phase: both models at full width through
   ``DecodeEngine.generate`` with ``use_kernels=True``, 8 prompts of 1024
   tokens and 32 greedy tokens, in float32 and bfloat16.  The prefill
   launches ``flash_attention`` once per local layer (8 for
   recurrentgemma-2b) and no SSM kernel, as the reference's prefill runs
   no SSM kernel.  Float32 tokens must equal the plain versions' run's,
   bfloat16 scores agree to SCORE_ATOL; prints prefill and decode tokens/s;
10. experiments phase: the paper's claims on the card, each main of
   ``repro_torch.experiments`` with its reference's asserts unchanged:
   fig3_sandwich and table2_time_to_acc at the reference's full setting
   (quick=False: 6 seeds, T=240 and T=300), fig3c_grouping,
   fig_e4_participation and fig_e8_multilevel at quick=True,
   table1_bounds and plan_deployment on the host, one JSON line each with
   its setting, result and wall seconds (if the phase takes longer than
   EXPERIMENTS_BUDGET_S, fig3 and table2 run at quick=True as well);
   table2's time to 75% under the paper's Table E.1 communication model
   beside the card's own training seconds to the same step;
   ``steps_per_sec`` of two_level(8, 2, 16, 4) at T=256 per step and
   through ``run_rounds`` (median of SPS_REPS); fig3's hsgd_N2 trajectory
   (seed 0, T=240) on the card against the CPU within LOSS_RTOL, and
   fig3c's four divergences on the same grads within DIV_RTOL of the
   largest; no kernel may launch (this path runs no codec);
11. runtime phase: the simulated runtime, elastic drop rounds and async
   stale slots on the sim.  The twin of ``benchmarks/bench_runtime.py``
   (``repro_torch.experiments.bench_runtime.matrix``: two topologies x
   four straggler regimes x three arms, T=96, from the reference's
   committed initial params) on the card and on the CPU: every simulated
   field and step to target equal, ``best_acc`` side by side, the same
   claims, and the only false claim three_level / bursty
   ``async_beats_elastic`` (as in the reference's own run).  Then the
   host cost of the three arms of two_level / bursty: wall seconds of an
   arm and ``run_rounds`` steps/s without evals, median of RUNTIME_REPS.
   Then the quickstart world through the new paths with codecs, launches
   counted from zero for each run: async int8 (``async_levels={1: 1}``),
   elastic int8 (a bursty runtime with ``DeadlineElastic(2.0)``, which must
   drop a worker) and async sign; each bit for bit the plain versions'
   run on the card, within LOSS_RTOL of the CPU run's loss, with the CPU
   run's wire bytes;
12. obs phase: the in-round probes, the metrics bus and traces.  On
   ``benchmarks/bench_obs.py``'s two topologies and model (batch
   OBS_BATCH, T=OBS_T, from one seed) ``run_rounds`` with
   ``metrics="on"`` on the card and on the CPU: every ``div_*`` value
   within DIV_RTOL of its row's largest, ``grad_norm`` within
   GRAD_NORM_RTOL relative, eq. (10) ``up + down == global`` per level on
   the card within DIV_RTOL; ``metrics=None`` bit for bit the probes-on
   run's params.  One local round and one sync round under
   ``torch.cuda.set_sync_debug_mode("warn")``, probes on and off: equal
   synchronizing-call counts, and a drain of the ring exactly one; the
   CUDA launches the probes add per local step and per sync round
   (``torch.profiler``), beside ``Metrics.op_budget("sim")`` (recorded,
   not asserted).  The twin ``repro_torch.experiments.bench_obs``'s
   timed leg on the card: ``ratio_best_pair >= MIN_RATIO`` (0.95) for
   both topologies, steps/s of every repeat printed.  The quickstart
   world as async int8 (``async_levels={1: 1}``) with probes on: the
   staleness channel nonzero exactly at the stale folds, bit for bit the
   plain versions' run and the probes-off run on the card, within
   LOSS_RTOL of the CPU run, its ``int8_scale_quantize`` launches counted.
   (Card against CPU runs at OBS_LR, where the CE stays well above
   float32's resolution; see the note at OBS_LR.)
   ``python -m repro_torch.obs`` (a runtime on) on the card and the CPU:
   the trace passes ``validate_trace`` and its event names equal the
   CPU's;
13. population phase: the twin ``repro_torch.experiments.
   bench_population``'s sweep (10^3 to 10^6 clients, k = 8) on the card:
   hydrated state bytes equal across the sweep and to the baseline's
   69,984, the ``k == population`` loop bit for bit row 0 of the
   materialized engine, seconds per step (host clock after a
   ``synchronize``) and draw ms printed.  ``run_sampled`` of that world at
   POP_CELLS for POP_ROUNDS rounds under int8, launches counted from
   zero: bit for bit the plain versions' run on the card, server loss
   within LOSS_RTOL of the CPU's, the CPU's wire bytes and participation;
   under top-k, one round's nonzero fold-back of the same slots on the
   card within POP_TOPK_RTOL of the CPU's, and whole runs within
   LOSS_RTOL in server loss, with the params' gap printed;
14. prints one ``{"ssm": ...}`` JSON line with the SSM throughputs, one
   ``{"topk_sim": ..., "mesh": ...}`` line, one ``{"experiments": ...}``
   line, one ``{"runtime": ...}`` line, one ``{"obs": ...}`` line, one
   ``{"population": ...}`` line, one ``{"kernels": [...]}`` JSON line (all
   nine kernels), then the result line ``{"ok": true, "device": {...}}``
   last.

Any failed phase exits non-zero before the result line.

    python3 chip_smoke.py --profile

builds the attention kernel and runs only the serving profile: qwen2-0.5b
at full width in bf16 with the kernel, ``torch.profiler`` over one prefill
(8 x 1024 tokens) and over DECODE_STEPS decode steps; it prints, per
phase, the CUDA kernels launched, their summed device time, the host's
wall time and the device's idle share, and the host ops that took most
time, then one JSON line.
"""
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = ("int8_codec", "sign_codec", "flash_attention", "ssd_scan",
           "rglru_scan", "topk_reduce")
BLOCK = 256
SHAPES = ((8, 2120), (8, 2**24 + 77))
SIGN_BLOCK = 1024
# (shape, block) of the sign kernel checks; the first two are timed
SIGN_CASES = (((8, 2120), SIGN_BLOCK), ((8, 2**24 + 77), SIGN_BLOCK),
              ((8, 2120), 64), ((8, 2120), 1000), ((8, 2120), 24))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# the float32 attention kernel's tensor-core operations per visible pair
# (six bf16 plane products each for Q.K^T and P.V) and its split
# pre-pass's bytes per element of q, k and v (read 4, write 6)
F32_SPLIT_OPS_PER_D = 24
F32_SPLIT_BYTES = 10
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
# flash attention cases: (B, Sq, Sk, Hq, Hk, D, dtype, causal, window);
# (a), (b) and (c), the first three, are timed
ATTN_CASES = (
    (8, 1024, 1024, 14, 2, 64, "bfloat16", True, None),    # (a) qwen2 prefill
    (1, 2048, 2048, 16, 8, 256, "bfloat16", True, 1024),   # (b) gemma3 local
    (8, 1024, 1024, 10, 1, 256, "bfloat16", True, 2048),   # (c) recurrentgemma
    *((2, 300, 300, 4, 2, d, "float32", True, None)
      for d in (32, 64, 96, 128, 192, 256)),
    *((2, 300, 300, 4, 2, d, "bfloat16", True, None) for d in (32, 192)),
    (1, 40, 40, 3, 1, 32, "bfloat16", True, 4),            # ragged S
    (2, 100, 260, 4, 2, 64, "bfloat16", False, None),      # Sq != Sk
    (1, 40, 40, 3, 1, 32, "float32", True, 4),             # ragged S
    (2, 1000, 1000, 4, 2, 64, "float32", True, None),      # ragged S
    (2, 100, 260, 4, 2, 64, "float32", False, None),       # Sq != Sk
    (2, 100, 260, 4, 2, 128, "bfloat16", False, None),
    (1, 200, 200, 4, 2, 128, "float32", True, 512),        # window > S
    (2, 130, 130, 4, 4, 96, "float32", True, None),        # Hq == Hk
    (2, 130, 130, 4, 4, 96, "bfloat16", True, 16),
    # rows of widely spread magnitude, float32 (see ATTN_ROWS)
    (2, 300, 300, 4, 2, 64, "float32", True, None, "rows"),
    (1, 256, 256, 4, 2, 256, "float32", True, 100, "rows"),
)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:32
# a "rows" case scales q, k and v by logspace(*ATTN_ROWS) along the
# sequence: 3.5 decades, so the bf16 planes' exponents vary from row to
# row.  Up to 10 (the codecs' range) the logits reach about 100, where
# float32 attention_ref itself lies several times the tolerance away from
# the same attention in float64, so no float32 kernel could be held to
# 2e-5 there; at these scales it lies within it
# (tests/test_torch_attention.py::test_f32_design_on_spread_rows).
ATTN_ROWS = (-3.0, 0.5)
# every float32 case is also held to the same attention in float64: max
# |o - o64| within ATTN_F32_ULPS * 2^-24 * max |o64|, and a control must
# miss that limit there: the float64 attention of the kernel's design
# without its lo planes (q, k, v and P cut to hi + mid), which 2e-5 alone
# would let through (``attention_f32_accuracy``).  Measured on an H100
# over ATTN_CASES (PERF.md §6): the kernel 2.1-56.2 (its wgmma float32
# sums, likely truncating), attention_ref 2.3-21.2, float32 SDPA 5.6-12.1,
# the control 306-1007.
ATTN_F32_ULPS = 128
ATTN_TPU_KERNEL = "src/repro/kernels/flash_attention.py:76"
# the serving phase: qwen2-0.5b at full width
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 1024, 32
DECODE_STEPS = 8             # decode steps under the profiler (--profile)
PREFILL_RTOL = 1e-3
# bf16 scores, kernel vs plain versions on the card.  Both compute
# attention in float32 and round its output to bf16; the kernel sums in
# another order, so some outputs differ by one bf16 ulp, and those
# differences compound through 24 bf16 layers and the tied 151,936-way
# head.  Measured on an H100 (PERF.md, PR 13): 0.0939 nats at most over 8
# requests, on scores of the 32 tokens near -300 (3e-4 relative).  The
# limit is about three times that, 1e-3 of the score.
SCORE_ATOL = 0.3
# card vs CPU final loss.  The codecs are bitwise the same on both
# devices, but PyTorch's CPU and CUDA float32 ops differ in the last bit
# inside the local updates, and an ulp can flip one int8 rounding, which
# moves that element by a whole quantum: the int8 wire path measured
# 2.24e-4 on an H100 (PERF.md), against 3e-3 between int8 and comms off.
# A sign flips only where an ulp moves a parameter across zero: the sign
# runs measured 0 to 1.2e-7, against a codec that moves the loss from 0.3
# to about 2.  The kernels themselves are held bitwise in the main path
# against the plain versions on the card.
LOSS_RTOL = 1e-3
MIN_ACC = 0.9
# SSD scan cases (Bt, S, H, P, N, chunk): the reference's sweep
# (tests/test_kernels.py:41-46, with a padded S and a single chunk), the
# largest state the kernel takes, mamba2-130m's full-width forward
# (8 x 1024), which is timed, the edges of the kernel's passes at full
# width: S = 1025 (17 chunks, one row in the last), S < chunk, and chunk
# 32, and odd P and N (P N no multiple of 4: the scalar state_pass and the
# single-element stores); each in float32 and bfloat16
SSD_TIMED = (8, 1024, 24, 64, 128, 64)
SSD_CASES = ((2, 32, 4, 8, 16, 8), (1, 40, 2, 16, 8, 16), (2, 64, 3, 8, 4, 64),
             (1, 16, 1, 4, 4, 4), (2, 100, 3, 64, 256, 64), SSD_TIMED,
             (8, 1025, 24, 64, 128, 64), (2, 40, 24, 64, 128, 64),
             (8, 1024, 24, 64, 128, 32), (2, 50, 3, 3, 5, 16))
# max |kernel - plain| / max |plain| (tests/test_kernels.py:56-57)
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# RG-LRU scan cases (Bt, S, W): the reference's sweep (tests/test_kernels.py
# :61-66) and recurrentgemma-2b's full-width forward, which is timed
RGLRU_CASES = ((2, 32, 8), (1, 50, 16), (2, 64, 4), (1, 8, 2),
               (8, 1024, 2560))
RGLRU_ATOL, RGLRU_RTOL = 5e-5, 1e-4     # tests/test_kernels.py:72-73
SSD_TPU_KERNEL = "src/repro/kernels/ssd_scan.py:58"
RGLRU_TPU_KERNEL = "src/repro/kernels/rglru_scan.py:47"
# the SSM forward and serving phases, at full width
SSM_ARCHS = ("mamba2-130m", "recurrentgemma-2b")
SSM_BATCH, SSM_SEQ, SSM_GEN = 8, 1024, 32
# loss, kernels vs plain versions on the card.  In float32 the two routes
# differ by float32 rounding only: CE within 1e-4 relative, logits within
# PREFILL_RTOL of the largest.  In bfloat16 the kernels keep float32 inside
# and round once, where the plain route rounds attention's probabilities
# to bf16; the CE is held to 2e-2 nats.
CE_RTOL = 1e-4
CE_ATOL_BF16 = 2e-2
LOSS_REPS = 3        # timed loss calls after a warm-up at the full shape
# the top-k slice.  Cases (M, K, size, kind) of topk_decode_reduce: the
# quickstart's global and local syncs at rate 0.25 and its global sync at
# rate 1/16, the smallest payload, a masked (zeroed) member, and the timing
# shape, rate 1/16 of the codec timing length (1,048,581 = round(
# (2**24 + 77) / 16)), each with distinct indices in every member (bitwise);
# the reference's repeated-index cases (tests/test_comms.py); then the
# kernel's tiling edges (its tiles are 2**14 floats): a size just above one
# tile, one that is no multiple of it, indices below 0 and at or past size
# ("out of range", every third entry, dropped), and K = 0 below and above
# one tile
TOPK_TIMED = (8, 1048581, 2**24 + 77)
TOPK_CASES = ((8, 530, 2120, "distinct"), (4, 530, 2120, "distinct"),
              (8, 132, 2120, "distinct"), (1, 1, 7, "distinct"),
              (8, 530, 2120, "masked"), (*TOPK_TIMED, "distinct"),
              (16, 15, 244, "repeated"), (8, 4, 100, "repeated"),
              (4, 3000, 2**14 + 1, "distinct"),
              (8, 5000, 100003, "distinct"),
              (2, 40000, 20 * 2**14 + 3, "out of range"),
              (3, 0, 5000, "distinct"), (3, 0, 100000, "distinct"))
TOPK_REPEAT_TOL = 1e-6           # tests/test_comms.py:168-172
TOPK_RATE = 0.25
TOPK_WIRE_BYTES = 864960         # the JAX package's run, T=96, rate 0.25
TOPK_TPU_KERNEL = "src/repro/kernels/comms.py:156"
# the mesh phase: one gloo process per worker, all on the one card
MESH_WORKERS = 8
MESH_TIMEOUT = 400.0
MESH_ATOL = 1e-3                 # tests/test_differential.py:247
# the dense form of SimpleModel (one worker's bits independent of the
# batch of workers) against the matmul form it replaced: sim steps/s of
# DENSE_FORM_TURNS turns, each one run of either form back to back.  The
# host-bound runs spread by 10-20% from run to run on one card (PERF.md),
# in slow drifts, so the forms are compared by the median over the turns
# of the ratio within a turn (best runs and medians printed beside)
DENSE_FORM_TURNS = 32
DENSE_FORM_MIN_RATIO = 0.95
# exact mode against sim where the two are not bit for bit (ROADMAP C)
EXACT_FALLBACK_RTOL = 1e-6
# the experiments phase: the paper's claims (the seven mains of
# repro_torch.experiments) on the card.  fig3 and table2 run at the
# reference's full setting (quick=False); if the phase takes longer than
# EXPERIMENTS_BUDGET_S they run at quick=True as well.  Card against CPU:
# one trajectory's final loss within LOSS_RTOL relative (PERF.md §2), and
# fig3c's four divergences on the same grads within DIV_RTOL of the
# largest of the four
EXPERIMENTS_BUDGET_S = 180.0
DIV_RTOL = 1e-5
SPS_SPEC = (8, 2, 16, 4)         # two_level(8, 2, 16, 4)
SPS_T, SPS_REPS = 256, 3
# runtime phase: the host cost of the new paths is the median of this
# many runs of each arm; the false claim the twin must reproduce
RUNTIME_REPS = 3
RUNTIME_FALSE_CLAIMS = ["three_level/bursty/async_beats_elastic"]
# obs phase: card against CPU on bench_obs's topologies and model at this
# batch, length and learning rate (the twin's own batch of 512 is for its
# timed leg, which runs on the card only); grad_norm within this relative
# difference.  At the twin's lr of 0.08 every worker's one-label shard
# drives its CE to ~1e-6 in one step, where float32 resolves 1 - softmax
# to ~10% and the card's log_softmax rounds otherwise than the CPU's:
# grad_norm then differs by 1.3e-2 while the params agree to 3e-7 (PERF.md
# §6, PR 22).  At OBS_LR the CE stays above 0.3 over the OBS_T steps
OBS_BATCH, OBS_T, OBS_LR = 16, 32, 0.002
GRAD_NORM_RTOL = 1e-5
# host syncs are counted in each of this many calls of a round, after a
# warm-up call of the round and after one empty call of the counter (the
# first switch into the warn mode itself reports a sync, inside
# torch.cuda.set_sync_debug_mode).  Each sync is reported as its
# SYNC_FRAMES innermost Python frames
SYNC_CALLS, SYNC_FRAMES = 3, 6
# the probes' cost on a host-bound world: steps/s of the paper's world
# (two_level(8, 2, 16, 4), T=SPS_T) through run_rounds, probes on against
# off, OBS_HOST_REPS same-repeat pairs (printed, not asserted)
OBS_HOST_REPS = 3
# population phase: run_sampled of bench_population's world under int8 and
# top-k at these cells and rounds; the top-k nonzero fold-back of one
# round's slots on the card within POP_TOPK_RTOL (max |diff| over max |cpu|
# per leaf) of the CPU's fold of the same slots.  Whole top-k runs are held
# to LOSS_RTOL in server loss, as the quickstart's top-k runs are: a
# selection near a tie flips between card and CPU (the params then move by
# ~1e-3 at once, PERF.md §6, PR 22)
POP_CELLS, POP_ROUNDS = (10, 100), 8
POP_TOPK_RTOL = 1e-5
TPU_KERNEL = "src/repro/kernels/comms.py"
SOURCE = "src/repro_torch/kernels/csrc/{}.cu"


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, inner: int, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` of CUDA-event time around ``inner`` calls,
    per call, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def stage_ms(torch, fn, calls: int = 5) -> dict:
    """Device ms per launch of each CUDA kernel of ``fn`` (``torch.profiler``
    over ``calls`` calls after one untimed): its summed device time over
    the launches the profiler recorded, divided by their number.  On the
    H100 the profiler has recorded only 3 of 5 calls' launches of a kernel,
    so dividing by ``calls`` would understate it.  Every kernel timed so
    launches once per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("::")[-1].split("(")[0]:
            e.device_time_total / e.count / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def bound_ms(n_bytes: int, n_ops: int, ops_per_s: float = F32_OPS_PER_S):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over ``ops_per_s`` (default: the float32 rate)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


SASS_KEYS = ("HGMMA", "HMMA", "UTMALDG", "global float atomics",
             "global CAS")


def sass_census(lib: Path) -> dict:
    """Counts of the SASS instructions this script holds the redesigned
    kernels to, in one built library (``cuobjdump -sass``): warpgroup
    tensor-core products (HGMMA), warp-level ones (HMMA, ``mma.sync``), TMA
    loads (UTMALDG), and float atomics or compare-and-swaps on global
    memory; over the library, and under ``"functions"`` per kernel
    function (by its mangled name)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {lib}: {out.stderr}")
    count = dict.fromkeys(SASS_KEYS, 0)
    functions, fn = {}, count
    for line in out.stdout.splitlines():
        # "Function : <mangled name>" opens a kernel's listing
        if line.strip().startswith("Function :"):
            fn = functions.setdefault(line.split(":", 1)[1].strip(),
                                      dict.fromkeys(SASS_KEYS, 0))
            continue
        # "/*0070*/  [@P0] OPCODE.MODIFIERS operands ;  /* encoding */"
        words = line.split("*/", 1)[1].split() if "*/" in line else []
        if words and words[0].startswith("@"):
            words = words[1:]
        op = words[0] if words else ""
        is_global = op.startswith(("RED", "ATOMG", "ATOM."))
        for key, hit in (("HGMMA", op.startswith("HGMMA")),
                         ("HMMA", op.startswith("HMMA")),
                         ("UTMALDG", op.startswith("UTMALDG")),
                         ("global float atomics", is_global and "F32" in op),
                         ("global CAS", is_global and "CAS" in op)):
            count[key] += hit
            if fn is not count:
                fn[key] += hit
    return {**count, "functions": functions}


def kernel_phase(torch, kern, ref):
    """Bitwise checks and timings; returns {name: record}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    recs = {}
    for r, c in SHAPES:
        nb = -(-c // BLOCK)
        row_scale = torch.logspace(-2, 1, r, device="cuda")[:, None]
        x = torch.randn((r, c), generator=gen, device="cuda") * row_scale
        x[-1] = 0.0                                  # one all-zero row
        # the wire path's input scale: the group max over rows, halved on
        # the largest row (the last non-zero one) so it saturates at +-127
        _, own, _ = ref.int8_ref(x, BLOCK)
        group = own.amax(dim=0, keepdim=True).expand(r, nb).contiguous()
        group[-2] *= 0.5

        q_k, s_k = kern.int8_quantize(x, block=BLOCK)
        q_p, s_p, _ = ref.int8_ref(x, BLOCK)
        y_k = kern.int8_dequantize(q_k, s_k, block=BLOCK)
        y_p = ref.int8_dequant_ref(q_k, s_k, BLOCK)
        g_k = kern.int8_scale_quantize(x, group, block=BLOCK)
        g_p = ref.int8_scale_quant_ref(x, group, BLOCK)
        torch.cuda.synchronize()
        errs = {
            "int8_quantize": max(
                (q_k.int() - q_p.int()).abs().max().item(),
                (s_k - s_p).abs().max().item()),
            "int8_dequantize": (y_k - y_p).abs().max().item(),
            "int8_scale_quantize": (g_k.int() - g_p.int()).abs().max().item(),
        }
        check(torch.equal(q_k, q_p) and torch.equal(s_k, s_p),
              f"int8_quantize differs from its plain version at {(r, c)}")
        check(torch.equal(y_k, y_p),
              f"int8_dequantize differs from its plain version at {(r, c)}")
        check(torch.equal(g_k, g_p),
              f"int8_scale_quantize differs from its plain version at "
              f"{(r, c)}")
        check(int(g_k[-2].abs().max()) == 127,
              "the saturating row did not reach +-127")

        n, s = r * c, r * nb
        work = {   # (kernel call, plain call, bytes moved, f32 operations)
            "int8_quantize": (
                lambda: kern.int8_quantize(x, block=BLOCK),
                lambda: ref.int8_ref(x, BLOCK),
                4 * n + n + 4 * s, 7 * n + 2 * s),
            "int8_dequantize": (
                lambda: kern.int8_dequantize(q_k, s_k, block=BLOCK),
                lambda: ref.int8_dequant_ref(q_k, s_k, BLOCK),
                n + 4 * s + 4 * n, 2 * n),
            "int8_scale_quantize": (
                lambda: kern.int8_scale_quantize(x, group, block=BLOCK),
                lambda: ref.int8_scale_quant_ref(x, group, BLOCK),
                4 * n + 4 * s + n, 5 * n + s),
        }
        inner = 50 if n < 1 << 20 else 1
        for name, (fk, fp, nbytes, nops) in work.items():
            b_ms, b_by = bound_ms(nbytes, nops)
            rec = recs.setdefault(name, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], float(errs[name]))
            rec[(r, c)] = {"ms": time_ms(torch, fk, inner),
                           "plain_ms": time_ms(torch, fp, inner),
                           "bound_ms": b_ms, "bound_by": b_by}
        del x, q_k, s_k, q_p, s_p, y_k, y_p, g_k, g_p, group, own
        torch.cuda.empty_cache()
    return recs


def sign_kernel_phase(torch, kern, ref):
    """Bitwise checks of the sign kernels at SIGN_CASES, and timings at
    the first two; returns {name: record}."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    recs = {"sign_pack": {"max_abs_err": 0.0},
            "sign_unpack": {"max_abs_err": 0.0}}
    timed = {shape for shape, _ in SIGN_CASES[:2]}
    for (r, c), block in SIGN_CASES:
        nb = -(-c // block)
        row_scale = torch.logspace(-2, 1, r, device="cuda")[:, None]
        x = torch.randn((r, c), generator=gen, device="cuda") * row_scale
        x[:-1, ::7] = -0.0                           # packs as +
        x[-1] = 0.0                                  # one all-zero row
        bits, scale = kern.sign_pack(x, block=block)
        y = kern.sign_unpack(bits, scale, size=c, block=block)
        b_p, s_p = ref.sign_pack_ref(x, block)
        y_p = ref.sign_unpack_ref(bits, scale, c, block)
        torch.cuda.synchronize()
        at = f"{(r, c)} block {block}"
        check(torch.equal(bits, b_p) and torch.equal(scale, s_p),
              f"sign_pack differs from its plain version at {at}")
        check(torch.equal(y, y_p),
              f"sign_unpack differs from its plain version at {at}")
        shift = torch.arange(8, device="cuda", dtype=torch.uint8)
        signs = ((bits[..., None] >> shift) & 1).reshape(r, nb * block)
        check(bool(signs[:, c:].all()), f"padded tail bits not 1 at {at}")
        check(bool(signs[:-1, :c:7].all()), f"-0.0 did not pack as + at {at}")
        check(bool(signs[-1].all()) and not scale[-1].any(),
              f"the all-zero row did not pack as +0 at {at}")
        recs["sign_pack"]["max_abs_err"] = max(
            recs["sign_pack"]["max_abs_err"],
            float((bits.int() - b_p.int()).abs().max()),
            float((scale - s_p).abs().max()))
        recs["sign_unpack"]["max_abs_err"] = max(
            recs["sign_unpack"]["max_abs_err"],
            float((y - y_p).abs().max()))
        del signs, y_p, b_p, s_p
        if (r, c) in timed and block == SIGN_BLOCK:
            n, s, nbits = r * c, r * nb, r * nb * block // 8
            work = {   # (kernel call, plain call, bytes moved, operations)
                "sign_pack": (
                    lambda: kern.sign_pack(x, block=block),
                    lambda: ref.sign_pack_ref(x, block),
                    4 * n + nbits + 4 * s, 3 * n + s),
                "sign_unpack": (
                    lambda: kern.sign_unpack(bits, scale, size=c,
                                             block=block),
                    lambda: ref.sign_unpack_ref(bits, scale, c, block),
                    nbits + 4 * s + 4 * n, 3 * n),
            }
            inner = 50 if n < 1 << 20 else 1
            for name, (fk, fp, nbytes, nops) in work.items():
                b_ms, b_by = bound_ms(nbytes, nops)
                recs[name][(r, c)] = {
                    "ms": time_ms(torch, fk, inner),
                    "plain_ms": time_ms(torch, fp, inner),
                    "bound_ms": b_ms, "bound_by": b_by}
        del x, bits, scale, y
        torch.cuda.empty_cache()
    return recs


def quickstart(device: str, comms, spec=None, opt=None, executor=None,
               **cfg):
    """The quickstart world through HSGD.run_rounds, on the two-level
    hierarchy or ``spec`` (group sizes, periods), with sgd(0.08) or
    ``opt``, on the sim executor or ``executor``, with the further
    ``EngineConfig`` fields ``cfg`` (a runtime, async levels, a metrics
    plan); returns the final global loss and accuracy, the wire bytes, the
    launch counts of the run, its seconds, the runtime's report (None
    without one), the final params and error-feedback residuals of every
    worker (on the CPU; a mesh rank gathers them) and the history."""
    import torch
    from repro_torch.core import (EngineConfig, HSGD, HierarchySpec,
                                  make_topology)
    from repro_torch.data import (FederatedDataset, label_shard_partition,
                                  make_classification)
    from repro_torch.kernels import comms as kern
    from repro_torch.models import SimpleConfig, SimpleModel
    from repro_torch.optim import sgd

    x, y = make_classification(seed=0, num_classes=8, dim=24, per_class=80)
    ds = FederatedDataset(x, y, label_shard_partition(
        y, [[j] for j in range(8)], n_workers=8)).require_workers(8)
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=24, hidden=32,
                                     num_classes=8))
    topo = make_topology("two_level", n=8, N=2, G=16, I=4) if spec is None \
        else make_topology(HierarchySpec(*spec))
    engine = HSGD(model.loss, sgd(0.08) if opt is None else opt, topo,
                  EngineConfig(comms=comms, executor=executor, **cfg))
    state = engine.init(torch.Generator().manual_seed(0), model.init,
                        device=device)
    gb = {k: torch.as_tensor(v, device=device)
          for k, v in ds.global_batch().items()}

    def evaluate(st, t):
        wbar = engine.mean_params(st)
        return {"loss": float(model.loss(wbar, gb)[0]),
                "acc": float(model.accuracy(wbar, gb))}

    kern.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = engine.run_rounds(
        state, lambda t: ds.batch(t, 10), T=96, eval_every=16,
        eval_fn=evaluate)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kern.launch_counts)
    last = history[-1]
    from repro_torch.tree import tree_leaves
    gather = engine.executor.gather
    return {"loss": last["loss"], "acc": last["acc"],
            "wire_bytes": sum(r.get("wire_bytes", 0) for r in history),
            "launches": counts, "seconds": seconds,
            "steps_per_s": 96 / seconds,
            "runtime": engine.runtime_report(),
            "params": [p.cpu() for p in tree_leaves(gather(state.params))],
            "comms": None if state.comms is None else
            [r.cpu() for r in tree_leaves(gather(state.comms))],
            "history": history}


@contextlib.contextmanager
def plain_versions(kern, ref, kattn=None, kssd=None, krg=None):
    """Route the kernel wrappers of ``kern`` (the codecs) and, if given,
    ``kattn`` (attention), ``kssd`` and ``krg`` (the SSD and RG-LRU scans)
    to their plain PyTorch versions on the card, for a run to hold the
    kernels' run against."""
    plain = {
        (kern, "int8_quantize"): lambda x, block: ref.int8_ref(x, block)[:2],
        (kern, "int8_dequantize"): lambda q, s, block: ref.int8_dequant_ref(
            q, s, block),
        (kern, "int8_scale_quantize"): lambda x, s, block:
            ref.int8_scale_quant_ref(x, s, block),
        (kern, "sign_pack"): lambda x, block: ref.sign_pack_ref(x, block),
        (kern, "sign_unpack"): lambda b, s, size, block: ref.sign_unpack_ref(
            b, s, size, block),
        (kern, "topk_decode_reduce"): lambda v, i, size, block=256:
            ref.topk_reduce_ref(v, i, size),
    }
    if kattn is not None:
        plain[(kattn, "flash_attention")] = \
            lambda q, k, v, causal=True, window=None: ref.attention_ref(
                q, k, v, causal=causal, window=window)
    if kssd is not None:
        plain[(kssd, "ssd_scan")] = \
            lambda x, dt, A, B, C, chunk=64: ref.ssd_ref(x, dt, A, B, C)[0]
    if krg is not None:
        plain[(krg, "rglru_scan")] = lambda a, b: ref.rglru_ref(a, b)[0]
    saved = {key: getattr(*key) for key in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


# The main path's runs: (label, comms, spec, optimizer, the kernels the
# run must launch, the wire bytes of the JAX package's run of the same
# configuration, accuracy floor or None).  Specs and optimizers are built
# inside the run; comms is a factory because a Comms holds bucket plans.
def _runs():
    from repro_torch.comms import Comms
    from repro_torch.optim import momentum
    three_level = ((2, 2, 2), (8, 4, 2))
    return (
        ("int8", lambda: "int8", None, None, ("int8_scale_quantize",),
         439824, MIN_ACC),
        ("int8 legacy", lambda: Comms("int8", wire_reduce=False), None,
         None, ("int8_quantize", "int8_dequantize"), 439824, MIN_ACC),
        ("sign", lambda: "sign", None, None, ("sign_pack",), 56508, None),
        ("sign legacy", lambda: Comms("sign", wire_reduce=False), None,
         None, ("sign_pack", "sign_unpack"), 56508, None),
        ("sign three_level", lambda: "sign", three_level, None,
         ("sign_pack",), 139608, None),
        ("sign momentum", lambda: "sign", None, lambda: momentum(0.02),
         ("sign_pack",), 113016, None),
    )


def main_path_phase(torch, kern, ref):
    """Every run of ``_runs()`` on the card: with the kernels (launches
    counted), with the plain versions on the card (must give the same
    trajectory bit for bit), and on the CPU (same wire bytes, final loss
    within LOSS_RTOL).  Returns, per kernel, its
    launches in each run that uses it."""
    launches = {}
    for label, make, spec, opt, kernels, ref_bytes, min_acc in _runs():
        def run(device):
            return quickstart(device, make(), spec,
                              None if opt is None else opt())
        gpu = run("cuda")
        with plain_versions(kern, ref):
            plain = run("cuda")
        cpu = run("cpu")
        rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        print(f"main path {label}: cuda loss {gpu['loss']!r} acc "
              f"{gpu['acc']!r} wire_bytes {gpu['wire_bytes']} launches "
              f"{gpu['launches']} {gpu['seconds']:.3f} s | cuda plain "
              f"versions loss {plain['loss']!r} {plain['seconds']:.3f} s | "
              f"cpu loss {cpu['loss']!r} acc {cpu['acc']!r} wire_bytes "
              f"{cpu['wire_bytes']} {cpu['seconds']:.3f} s | cuda vs cpu "
              f"loss relative difference {rel!r}", flush=True)
        for name in kernels:
            check(gpu["launches"][name] > 0,
                  f"{label}: kernel {name} was never launched")
            launches.setdefault(name, {})[label] = gpu["launches"][name]
        check(not any(plain["launches"].values()),
              f"{label}: the plain-version run launched a kernel")
        check(all(torch.equal(a, b)
                  for a, b in zip(gpu["params"], plain["params"]))
              and gpu["loss"] == plain["loss"],
              f"{label}: the kernels' trajectory differs from the plain "
              "versions' on the card")
        check(math.isfinite(gpu["loss"]), f"{label}: loss is not finite")
        if min_acc is not None:
            check(min(gpu["acc"], cpu["acc"]) >= min_acc,
                  f"{label}: accuracy {gpu['acc']} (cuda) {cpu['acc']} "
                  f"(cpu) < {min_acc}")
        check(gpu["wire_bytes"] == cpu["wire_bytes"] == ref_bytes,
              f"{label}: wire bytes {gpu['wire_bytes']} on cuda, "
              f"{cpu['wire_bytes']} on cpu, {ref_bytes} in the JAX "
              "package's run")
        check(rel <= LOSS_RTOL,
              f"{label}: loss {gpu['loss']} on cuda vs {cpu['loss']} on "
              f"cpu, relative difference {rel} > {LOSS_RTOL}")
    return launches


def topk_kernel_phase(torch, kern, ref):
    """``topk_decode_reduce`` against ``topk_reduce_ref`` on the card at
    TOPK_CASES: bit for bit, and the same on a second call, where each
    member's indices are distinct; to TOPK_REPEAT_TOL where they repeat.
    Times kernel, plain version and the ``index_add_`` yardstick at
    TOPK_TIMED.  Returns the kernel's record."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rec = {"max_abs_err": 0.0, "max_abs_err_repeated": 0.0}
    for m, k, size, kind in TOPK_CASES:
        vals = torch.randn((m, k), generator=gen, device="cuda")
        if kind == "repeated":
            idx = torch.randint(0, size, (m, k), generator=gen,
                                device="cuda", dtype=torch.int32)
        else:
            idx = torch.stack([
                torch.randperm(size, generator=gen, device="cuda")[:k]
                for _ in range(m)]).to(torch.int32)
        if kind == "masked":
            vals[m // 2] = 0.0                       # a masked-out member
        if kind == "out of range":                   # still distinct
            idx[:, 0::3] = -1 - idx[:, 0::3]
            idx[:, 1::3] += size
        out = kern.topk_decode_reduce(vals, idx, size=size)
        again = kern.topk_decode_reduce(vals, idx, size=size)
        want = ref.topk_reduce_ref(vals, idx, size)
        torch.cuda.synchronize()
        at = f"(M, K, size) = {(m, k, size)} {kind}"
        err = float((out - want).abs().max())
        if kind == "repeated":
            check(torch.allclose(out, want, atol=TOPK_REPEAT_TOL,
                                 rtol=TOPK_REPEAT_TOL),
                  f"topk_decode_reduce differs from its plain version by "
                  f"{err} at {at}")
            rec["max_abs_err_repeated"] = max(rec["max_abs_err_repeated"],
                                              err)
        else:
            check(torch.equal(out, want) and torch.equal(again, out),
                  f"topk_decode_reduce differs from its plain version (or "
                  f"from itself) at {at}: max |diff| {err}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"topk_decode_reduce {at}: max |kernel - plain| {err!r}",
              flush=True)
        if (m, k, size) == TOPK_TIMED:
            nbytes, nops = m * k * 8 + size * 4, m * k
            b_ms, b_by = bound_ms(nbytes, nops)
            flat_i, flat_v = idx.reshape(-1), vals.reshape(-1)
            rec.update(
                shape=[m, k, size], bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
                ms=time_ms(torch, lambda: kern.topk_decode_reduce(
                    vals, idx, size=size), 1),
                plain_ms=time_ms(torch, lambda: ref.topk_reduce_ref(
                    vals, idx, size), 1),
                library_ms=time_ms(torch, lambda: torch.zeros(
                    size, device="cuda").index_add_(0, flat_i, flat_v), 1))
            rec["stage_ms"] = stage_ms(torch, lambda: kern.topk_decode_reduce(
                vals, idx, size=size))
            print(f"topk_decode_reduce {at}: kernel {rec['ms']:.5f} ms, "
                  f"plain {rec['plain_ms']:.5f} ms, index_add_ "
                  f"{rec['library_ms']:.5f} ms, bound {b_ms:.5f} ms "
                  f"({b_by}); device ms per call by kernel "
                  f"{rec['stage_ms']}", flush=True)
        del vals, idx, out, again, want
        torch.cuda.empty_cache()
    return rec


def topk_sim_phase(torch):
    """The quickstart world with ``Comms("topk", rate=TOPK_RATE)`` on the
    sim executor, wire path and legacy roundtrip, on the card and on the
    CPU: the JAX package's wire bytes, the CPU run's loss within LOSS_RTOL.
    Sim's top-k reduce is the dense group mean: no kernel launches."""
    from repro_torch.comms import Comms
    out = {}
    for label, wire in (("topk sim", True), ("topk sim legacy", False)):
        def run(device):
            return quickstart(device, Comms("topk", rate=TOPK_RATE,
                                            wire_reduce=wire))
        gpu, cpu = run("cuda"), run("cpu")
        rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        print(f"{label}: cuda loss {gpu['loss']!r} acc {gpu['acc']!r} "
              f"wire_bytes {gpu['wire_bytes']} {gpu['seconds']:.3f} s "
              f"({gpu['steps_per_s']:.1f} steps/s) | cpu loss "
              f"{cpu['loss']!r} acc {cpu['acc']!r} | relative difference "
              f"{rel!r}", flush=True)
        check(math.isfinite(gpu["loss"]), f"{label}: loss is not finite")
        check(gpu["wire_bytes"] == cpu["wire_bytes"] == TOPK_WIRE_BYTES,
              f"{label}: wire bytes {gpu['wire_bytes']} on cuda, "
              f"{cpu['wire_bytes']} on cpu, {TOPK_WIRE_BYTES} in the JAX "
              "package's run")
        check(rel <= LOSS_RTOL, f"{label}: loss {gpu['loss']} on cuda vs "
              f"{cpu['loss']} on cpu, relative difference {rel} > "
              f"{LOSS_RTOL}")
        check(not any(gpu["launches"].values()),
              f"{label}: sim launched {gpu['launches']}")
        out[label] = {k: gpu[k] for k in ("loss", "acc", "seconds",
                                          "steps_per_s", "wire_bytes")}
    return out


# The mesh phase's runs: (label, comms, spec, exact, the kernels every rank
# must launch; topk_decode_reduce exactly once per sync).  comms is a
# factory because a Comms holds bucket plans.  Production runs hold their
# params to MESH_ATOL of the sim on the card and their loss to LOSS_RTOL.
def _mesh_runs():
    from repro_torch.comms import Comms

    def topk():
        return Comms("topk", rate=TOPK_RATE)
    three_level = ((2, 2, 2), (8, 4, 2))
    return (
        ("exact none", lambda: None, None, True, ()),
        ("exact int8", lambda: "int8", None, True, ("int8_scale_quantize",)),
        ("exact sign", lambda: "sign", None, True, ("sign_pack",)),
        ("exact topk", topk, None, True, ()),
        ("topk", topk, None, False, ("topk_decode_reduce",)),
        ("topk three_level", topk, three_level, False,
         ("topk_decode_reduce",)),
        ("int8", lambda: "int8", None, False, ("int8_scale_quantize",)),
    )


def wire_lowering_check(device: str):
    """Both lowerings of one sync on the same inputs, in every rank: the
    int8 and top-k codecs' reduce through MeshWireOps (production) and
    through ExactWireOps (the sim's arithmetic on the gathered block), at
    every level of the two-level world, unmasked and masked, on a seeded
    (1, 2120) payload per rank.  Returns {case: max |diff|} (int8 must be
    0: its collective sums int32 and takes a max; top-k sums its members in
    another order than the sim's mean)."""
    import torch
    from repro_torch.comms.codecs import Int8Compressor, TopKCompressor
    from repro_torch.comms.reduce import ExactWireOps, MeshWireOps
    from repro_torch.launch.mesh import make_hsgd_mesh
    mesh = make_hsgd_mesh((2, 4))
    rank = mesh.rank
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn((1, 2120), generator=gen).to(device)
    res = (torch.randn((1, 2120), generator=gen) * 0.1).to(device)
    out = {}
    for level in (1, 2):
        for mask in (None, torch.tensor([1, 0, 1, 1, 0, 1, 1, 1],
                                        dtype=torch.bool, device=device)):
            prod = MeshWireOps(mesh.axes(mesh.axis_names[level - 1:]), mask,
                               rank)
            exact = ExactWireOps(mesh.world, rank, (2, 4), level, mask)
            tag = f"level {level}{' masked' if mask is not None else ''}"
            a = Int8Compressor().reduce(x, prod)
            b = Int8Compressor().reduce(x, exact)
            out[f"int8 {tag}"] = float((a - b).abs().max())
            (a, ra), (b, rb) = (TopKCompressor(TOPK_RATE).reduce(x, ops, res)
                                for ops in (prod, exact))
            out[f"topk {tag}"] = float((a - b).abs().max())
            out[f"topk residual {tag}"] = float((ra - rb).abs().max())
    return out


def _digest(run) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in run["params"] + (run["comms"] or []):
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def mesh_rank(rank: int, device: str):
    """One rank of the mesh phase: every run of ``_mesh_runs()`` through
    ``MeshExecutor``, launch counts from zero for each.  Rank 0 returns its
    runs and every rank's launches, seconds and state digests."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import MeshExecutor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, summary = {}, {}
    for label, make, spec, exact, _ in _mesh_runs():
        run = quickstart(device, make(), spec,
                         executor=MeshExecutor(exact=exact))
        out[label] = run
        summary[label] = (run["launches"], run["seconds"], _digest(run))
    summary["lowering"] = wire_lowering_check(device)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, summary)
    return {"runs": out, "ranks": everyone}


def batched_first_difference(torch, device: str, repeat: bool):
    """Where a worker's update computed alone first differs from the sim's
    (vmap over all 8 workers) on ``device``, for the quickstart model's
    first step: the name of the first stage whose rows differ, or None.
    Alone is vmap over its 1 row (the production mesh) or, with
    ``repeat``, over its row repeated 8 times (the exact mesh)."""
    from repro_torch.data import (FederatedDataset, label_shard_partition,
                                  make_classification)
    from repro_torch.models import SimpleConfig, SimpleModel, simple
    x, y = make_classification(seed=0, num_classes=8, dim=24, per_class=80)
    ds = FederatedDataset(x, y, label_shard_partition(
        y, [[j] for j in range(8)], n_workers=8))
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=24, hidden=32,
                                     num_classes=8))
    p0 = model.init(torch.Generator().manual_seed(0), device=device)
    params = {k: {n: v[None].expand((8,) + tuple(v.shape)).contiguous()
                  for n, v in d.items()} for k, d in p0.items()}
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in ds.batch(0, 10).items()}
    vmap = torch.func.vmap
    grad = torch.func.grad(lambda p, b: model.loss(p, b)[0])
    stages = (
        ("h1 = x W1 + b1", lambda p, b: simple._affine(b["x"], p["h1"])),
        ("logits", lambda p, b: model.logits(p, b["x"])),
        ("loss", lambda p, b: model.loss(p, b)[0]),
        ("grad of W1", lambda p, b: grad(p, b)["h1"]["w"]),
        ("grad of W2", lambda p, b: grad(p, b)["h2"]["w"]),
        ("grad of Wout", lambda p, b: grad(p, b)["out"]["w"]),
    )
    def alone(v, r):
        v = v[r:r + 1]
        return v.repeat((8,) + (1,) * (v.ndim - 1)) if repeat else v

    for name, fn in stages:
        every = vmap(fn)(params, batch)
        for r in range(8):
            row = vmap(fn)(
                {k: {n: alone(v, r) for n, v in d.items()}
                 for k, d in params.items()},
                {k: alone(v, r) for k, v in batch.items()})
            if not torch.equal(every[r:r + 1], row[:1]):
                return f"{name}, worker {r}"
    return None


def _matmul_affine(x, p):
    """The dense layer as a matmul, which under vmap is a batched cuBLAS
    product: the form ``models/simple.py::_affine`` replaced."""
    return x @ p["w"] + p["b"]


def dense_forms(torch, device: str):
    """The sim's steps/s on the quickstart world (int8 wire path) under the
    model's dense form (``models/simple.py::_affine``, a product and a sum
    over din) and under the matmul form it replaced, in turns (matmul,
    port, port, matmul, ...), with where a worker's update alone first
    differs from the batch of 8 under each.  The port's form must keep
    DENSE_FORM_MIN_RATIO of the matmul form's steps/s (the median of the
    per-turn ratios)."""
    from repro_torch.models import simple
    port = simple._affine
    forms = {"product and sum": port, "matmul": _matmul_affine}
    rec = {name: {"steps_per_s": []} for name in forms}
    try:
        for name, fn in forms.items():
            simple._affine = fn
            rec[name]["first_difference_one_row"] = batched_first_difference(
                torch, device, repeat=False)
        for turn in range(DENSE_FORM_TURNS):
            for name in (("matmul", "product and sum") if turn % 2 == 0
                         else ("product and sum", "matmul")):
                simple._affine = forms[name]
                rec[name]["steps_per_s"].append(
                    quickstart(device, "int8")["steps_per_s"])
    finally:
        simple._affine = port
    for r in rec.values():
        r["median_steps_per_s"] = statistics.median(r["steps_per_s"])
        r["best_steps_per_s"] = max(r["steps_per_s"])
    turns = [a / b for a, b in zip(rec["product and sum"]["steps_per_s"],
                                   rec["matmul"]["steps_per_s"])]
    ratio = statistics.median(turns)
    rec["ratio"] = ratio
    rec["turn_ratios"] = turns
    print(f"dense forms, sim int8 steps/s in turns: product and sum "
          f"{rec['product and sum']['steps_per_s']} (best "
          f"{rec['product and sum']['best_steps_per_s']:.1f}, median "
          f"{rec['product and sum']['median_steps_per_s']:.1f}), matmul "
          f"{rec['matmul']['steps_per_s']} (best "
          f"{rec['matmul']['best_steps_per_s']:.1f}, median "
          f"{rec['matmul']['median_steps_per_s']:.1f}), median ratio "
          f"within a turn {ratio:.4f}; "
          f"first difference of a worker alone: product and sum "
          f"{rec['product and sum']['first_difference_one_row']}, matmul "
          f"{rec['matmul']['first_difference_one_row']}", flush=True)
    check(ratio >= DENSE_FORM_MIN_RATIO,
          f"the dense form keeps {ratio:.4f} of the matmul form's sim "
          f"steps/s, below {DENSE_FORM_MIN_RATIO}")
    return rec


def mesh_phase(torch, device: str = "cuda"):
    """``MeshExecutor`` in MESH_WORKERS gloo processes on one card (every
    collective crosses the host), against the sim on the same card:
    ``exact=True`` bit for bit (params, residuals, loss), the production
    lowering within MESH_ATOL of the params and LOSS_RTOL of the loss; the
    kernels each run must launch, on every rank, topk_decode_reduce once
    per sync; every rank's gathered state the same.  Returns the record."""
    from repro_torch.core import HierarchySpec, make_topology
    from repro_torch.launch.mesh import launch
    t0 = time.perf_counter()
    res = launch(mesh_rank, MESH_WORKERS, backend="gloo", device=device,
                 args=(device,), timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    print(f"mesh: {MESH_WORKERS} gloo ranks on one card, launch and every "
          f"run in {wall:.1f} s", flush=True)
    forms = dense_forms(torch, device)
    out = {"wall_s": wall, "runs": {}, "exact_bitwise": True,
           "first_difference_one_row":
               forms["product and sum"]["first_difference_one_row"],
           "first_difference_repeated_row": batched_first_difference(
               torch, device, repeat=True),
           "dense_forms": forms}
    print(f"mesh: a worker's update alone vs the sim's batch of 8 first "
          f"differs at: {out['first_difference_one_row']} (one row, the "
          f"production mesh); {out['first_difference_repeated_row']} (its "
          "row repeated 8 times, the exact mesh)", flush=True)
    check(out["first_difference_one_row"] is None,
          "a worker's update over its one row differs from the same row in "
          f"the sim's batch of 8 at {out['first_difference_one_row']}")
    lowering = {case: max(r["lowering"][case] for r in res["ranks"])
                for case in res["ranks"][0]["lowering"]}
    print(f"mesh: production vs exact lowering of one sync on shared "
          f"inputs, max |diff| over the ranks: {lowering}", flush=True)
    for case, diff in lowering.items():
        check(diff == 0.0 if case.startswith(("int8", "topk residual"))
              else diff <= EXACT_FALLBACK_RTOL,
              f"mesh lowering {case}: production differs from exact by "
              f"{diff}")
    out["lowering"] = lowering
    for label, make, spec, exact, kernels in _mesh_runs():
        mesh = res["runs"][label]
        ranks = [r[label] for r in res["ranks"]]
        sim = quickstart(device, make(), spec)
        topo = make_topology("two_level", n=8, N=2, G=16, I=4) \
            if spec is None else make_topology(HierarchySpec(*spec))
        syncs = sum(ev is not None for ev in topo.schedule(96))
        diff = max(float((a - b).abs().max())
                   for a, b in zip(mesh["params"], sim["params"]))
        scale = max(float(b.abs().max()) for b in sim["params"])
        rel = abs(mesh["loss"] - sim["loss"]) / abs(sim["loss"])
        print(f"mesh {label}: loss {mesh['loss']!r} acc {mesh['acc']!r} "
              f"{mesh['seconds']:.3f} s ({mesh['steps_per_s']:.1f} "
              f"steps/s, rank 0) | sim on the card loss {sim['loss']!r} "
              f"{sim['seconds']:.3f} s ({sim['steps_per_s']:.1f} steps/s) "
              f"| max |params diff| {diff!r} | launches per rank "
              f"{[{k: v for k, v in r[0].items() if v} for r in ranks]}",
              flush=True)
        check(len({r[2] for r in ranks}) == 1,
              f"mesh {label}: the ranks gathered different states")
        check(mesh["wire_bytes"] == sim["wire_bytes"],
              f"mesh {label}: wire bytes {mesh['wire_bytes']} vs sim "
              f"{sim['wire_bytes']}")
        for name in kernels:
            per_rank = [r[0][name] for r in ranks]
            want = syncs if name == "topk_decode_reduce" else None
            check(all(n > 0 for n in per_rank) and
                  (want is None or per_rank == [want] * MESH_WORKERS),
                  f"mesh {label}: {name} launched {per_rank} times on the "
                  f"ranks (want {want or 'at least once'} on each)")
        if "topk_decode_reduce" not in kernels:
            check(all(r[0]["topk_decode_reduce"] == 0 for r in ranks),
                  f"mesh {label}: topk_decode_reduce launched")
        rec = {"loss": mesh["loss"], "acc": mesh["acc"],
               "seconds": mesh["seconds"], "steps_per_s":
               mesh["steps_per_s"], "sim_seconds": sim["seconds"],
               "sim_steps_per_s": sim["steps_per_s"],
               "max_abs_params_diff": diff,
               "launches_per_rank": {k: ranks[0][0][k] for k in kernels}}
        if exact:
            same = all(torch.equal(a, b)
                       for a, b in zip(mesh["params"], sim["params"]))
            if mesh["comms"] is not None:
                same = same and all(torch.equal(a, b) for a, b in zip(
                    mesh["comms"], sim["comms"]))
            same = same and mesh["loss"] == sim["loss"]
            rec["bitwise"] = same
            if not same:
                out["exact_bitwise"] = False
                print(f"mesh {label}: NOT bit for bit the sim", flush=True)
                check(diff <= EXACT_FALLBACK_RTOL * scale,
                      f"mesh {label}: exact mode differs from sim by {diff} "
                      f"> {EXACT_FALLBACK_RTOL} x {scale}")
        else:
            check(diff < MESH_ATOL, f"mesh {label}: params differ from "
                  f"sim by {diff} >= {MESH_ATOL}")
            check(rel <= LOSS_RTOL, f"mesh {label}: loss {mesh['loss']} vs "
                  f"sim {sim['loss']}, relative difference {rel}")
        out["runs"][label] = rec
    return out


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask lets through, counted row by row."""
    import numpy as np
    i = np.arange(sq)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.zeros(sq, np.int64) if window is None \
        else np.maximum(i - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_timing(torch, kattn, ref, q, k, v, want, at):
    """Kernel, plain version and one ``scaled_dot_product_attention`` call
    at ``at``'s causal mask and window, on q, k, v in their own dtype,
    beside the bounds.  bf16: 4*D tensor-core operations per visible pair
    (the function's), 6*D and 8*D (two and three bf16 terms of P); float32:
    the kernel's bound, the split pre-pass's bytes plus the larger of the
    attention launch's bytes (the planes read, o written) and its 24*D
    tensor-core operations (six bf16 plane products each for Q.K^T and
    P.V), with the device ms of each of its two launches (``stage_ms``).
    Both also give ``f32_core_ms``, 4*D operations at the float32 rate
    outside the tensor cores, the ceiling of a kernel on the CUDA cores
    (TF32 is off for the library call too).  Returns the record and the
    library call's output."""
    import torch.nn.functional as F
    b, sq, sk, hq, hk, d, _, causal, window = at[:9]
    dtype = str(q.dtype).split(".")[-1]
    tol = ATTN_TOL[dtype]
    pairs = visible_pairs(sq, sk, causal, window)
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None or window >= sk:
        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        pos = torch.arange(sq, device="cuda")
        gap = pos[:, None] - pos[None, :]
        mask = (gap >= 0) & (gap < window)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

    def kernel():
        return kattn.flash_attention(q, k, v, causal=causal, window=window)

    out = kernel()
    err = float((out.float() - want.float()).abs().max())
    check(bool(torch.isfinite(out).all()) and bool(torch.allclose(
        out.float(), want.float(), atol=tol, rtol=tol)),
          f"flash_attention differs from its plain version at {at} in "
          f"{dtype}: max |diff| {err}")
    lib_out = library().transpose(1, 2)
    lib_err = float((lib_out.float() - want.float()).abs().max())
    check(lib_err <= tol, f"the library call computes another "
          f"function at {at} in {dtype}: max |diff| {lib_err}")
    t = {"shape": list(at[:6]) + [dtype] + list(at[7:9]),
         "visible_pairs": pairs, "flops": flops, "bytes": nbytes,
         "max_abs_err": err, "library_max_abs_err": lib_err,
         "ms": time_ms(torch, kernel, 5),
         "plain_ms": time_ms(torch, lambda: ref.attention_ref(
             q, k, v, causal=causal, window=window), 2, reps=10),
         "library_ms": time_ms(torch, library, 5),
         "f32_core_ms": flops / F32_OPS_PER_S * 1e3}
    if dtype == "bfloat16":
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops,
                                                BF16_OPS_PER_S)
        t["bound_6d_ms"] = bound_ms(nbytes, flops * 3 // 2,
                                    BF16_OPS_PER_S)[0]
        t["bound_8d_ms"] = bound_ms(nbytes, flops * 2, BF16_OPS_PER_S)[0]
        extra = (f" at 4*D, {t['bound_6d_ms']:.5f} ms at 6*D, "
                 f"{t['bound_8d_ms']:.5f} ms at 8*D")
    else:
        elems = q.numel() + k.numel() + v.numel()
        t["split_bound_ms"] = (F32_SPLIT_BYTES * elems / HBM_BYTES_PER_S
                               * 1e3)
        launch_ms, t["bound_by"] = bound_ms(
            6 * elems + 4 * q.numel(), flops * F32_SPLIT_OPS_PER_D // 4,
            BF16_OPS_PER_S)
        t["bound_ms"] = t["split_bound_ms"] + launch_ms
        t["launches_ms"] = stage_ms(torch, kernel)
        extra = (f" (24*D on the tensor cores, {launch_ms:.5f}, after the "
                 f"split pre-pass's bytes, {t['split_bound_ms']:.5f}); "
                 f"device ms by launch {t['launches_ms']}")
    print(f"flash_attention {t['shape']}: kernel {t['ms']:.5f} ms, plain "
          f"{t['plain_ms']:.5f} ms, library {t['library_ms']:.5f} ms, bound "
          f"{t['bound_ms']:.5f} ms{extra} ({t['bound_by']}), f32 CUDA-core "
          f"ceiling {t['f32_core_ms']:.5f} ms", flush=True)
    return t, lib_out


def attention_f64(torch, q, k, v, causal, window, drop_lo=False):
    """Softmax attention of float32 q, k, v in float64, on their device.
    With ``drop_lo``, the float32 kernel's design without its lo planes:
    q, k, v and the probabilities P cut to hi + mid (their top 16
    significand bits, as the kernel's truncation cuts them), then the
    products exact: what a kernel that never read the lo planes would
    compute, before its own float32 sums."""
    def cut(x):
        if not drop_lo:
            return x.double()
        x = x.float()
        hi = (x.view(torch.int32) & -65536).view(torch.float32)
        mid = ((x - hi).view(torch.int32) & -65536).view(torch.float32)
        return (hi + mid).double()

    n_rep = q.shape[2] // k.shape[2]
    qd = cut(q)
    kd = cut(k).repeat_interleave(n_rep, dim=2)
    vd = cut(v).repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / math.sqrt(q.shape[-1])
    sq, sk = q.shape[1], k.shape[1]
    pos_q = torch.arange(sq, device=q.device)[:, None]
    pos_k = torch.arange(sk, device=q.device)[None, :]
    seen = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        seen &= pos_k <= pos_q
    if window is not None:
        seen &= (pos_q - pos_k) < window
    s = torch.where(seen, s, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", cut(p), vd)
    return o / l.transpose(1, 2)


def attention_f32_accuracy(torch, q, k, v, at, outs):
    """Each float32 output in ``outs`` (name -> tensor), and the control
    (``attention_f64`` with ``drop_lo``), against the same attention in
    float64: max |x - o64| in units of 2^-24 * max |o64|."""
    causal, window = at[7], at[8]
    exact = attention_f64(torch, q, k, v, causal, window)
    unit = 2.0**-24 * float(exact.abs().max())
    ulps = {name: float((x.double() - exact).abs().max()) / unit
            for name, x in outs.items()}
    ulps["control"] = float((attention_f64(
        torch, q, k, v, causal, window, drop_lo=True)
        - exact).abs().max()) / unit
    return ulps


def attention_inputs(torch, gen, case):
    """q, k, v of an ATTN_CASES entry, normal in float32 and then cast to
    its dtype; a "rows" case scales every row (sequence position) of all
    three by logspace(*ATTN_ROWS)."""
    b, sq, sk, hq, hk, d, dtype, causal, window, *rows = case
    out = []
    for s, h in ((sq, hq), (sk, hk), (sk, hk)):
        x = torch.randn((b, s, h, d), generator=gen, device="cuda")
        if rows:
            x *= torch.logspace(*ATTN_ROWS, s, device="cuda")[:, None, None]
        out.append(x.to(getattr(torch, dtype)))
    return out


def attention_kernel_phase(torch, kattn, ref):
    """``flash_attention`` against ``attention_ref`` on the card at
    ATTN_CASES; timings at (a), (b) and (c), each beside one
    ``scaled_dot_product_attention`` call of the same function (causal;
    (b)'s window as a boolean mask built outside the timed region) and the
    bounds (``attention_timing``); (a), (b) and (c) also in float32, on
    inputs drawn in float32 (so their mid and lo planes are not zero).
    Every float32 case is also held to float64 within ATTN_F32_ULPS, and
    the control must miss that limit (``attention_f32_accuracy``).
    Returns the kernel's record."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    gen_f32 = torch.Generator(device="cuda").manual_seed(3)
    rec = {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "timed": [],
           "timed_f32": [], "f32_ulps": []}

    def against_f64(q, k, v, at, outs):
        ulps = attention_f32_accuracy(torch, q, k, v, at, outs)
        rec["f32_ulps"].append({"case": list(at), **ulps})
        print(f"flash_attention {at} float32 against float64, in 2^-24 of "
              f"max |o|: {ulps}", flush=True)
        check(ulps["kernel"] <= ATTN_F32_ULPS,
              f"flash_attention float32 at {at}: {ulps['kernel']} x 2^-24 "
              f"of max |o| from float64, over {ATTN_F32_ULPS}")
        check(ulps["control"] > ATTN_F32_ULPS,
              f"flash_attention float32 at {at}: the design without lo "
              f"planes is {ulps['control']} x 2^-24 of max |o| from "
              f"float64, within {ATTN_F32_ULPS}: the limit does not "
              "separate the designs")

    for i, at in enumerate(ATTN_CASES):
        b, sq, sk, hq, hk, d, dtype, causal, window = at[:9]
        dt = getattr(torch, dtype)
        q, k, v = attention_inputs(torch, gen, at)
        out = kattn.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = ATTN_TOL[dtype]
        check(out.dtype == dt and out.shape == q.shape,
              f"flash_attention: wrong output {out.dtype} {tuple(out.shape)} "
              f"at {at}")
        err = float((out.float() - want.float()).abs().max())
        check(bool(torch.isfinite(out).all()) and bool(torch.allclose(
            out.float(), want.float(), atol=tol, rtol=tol)),
              f"flash_attention differs from its plain version at {at}: "
              f"max |diff| {err}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"flash_attention {at}: max |kernel - plain| {err!r}",
              flush=True)
        if dtype == "float32":
            rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], err)
            against_f64(q, k, v, at, {"kernel": out, "plain": want})
        if i < 3:
            rec["timed"].append(
                attention_timing(torch, kattn, ref, q, k, v, want, at)[0])
        del q, k, v, out, want
        torch.cuda.empty_cache()
        if i < 3:
            at32 = at[:6] + ("float32",) + at[7:]
            q, k, v = attention_inputs(torch, gen_f32, at32)
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            t, lib_out = attention_timing(torch, kattn, ref, q, k, v, want,
                                          at32)
            rec["timed_f32"].append(t)
            rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"],
                                         t["max_abs_err"])
            out = kattn.flash_attention(q, k, v, causal=causal,
                                        window=window)
            against_f64(q, k, v, at32, {"kernel": out, "plain": want,
                                        "library": lib_out})
            del q, k, v, want, out, lib_out
            torch.cuda.empty_cache()
    rec["f32_ulps_max"] = max(u["kernel"] for u in rec["f32_ulps"])
    return rec


@contextlib.contextmanager
def recording_windows(kattn):
    """Record the ``window`` of every call of the attention wrapper (the
    calls go through to it, so it counts its launches as always)."""
    real, seen = kattn.flash_attention, []

    def spy(q, k, v, *, causal=True, window=None):
        seen.append(window)
        return real(q, k, v, causal=causal, window=window)

    kattn.flash_attention = spy
    try:
        yield seen
    finally:
        kattn.flash_attention = real


def serve(torch, counters, cfg, batch, prompt_len, gen_len, seed=0):
    """``cfg`` at random weights through ``DecodeEngine.generate`` on the
    card, the launches of every wrapper module in ``counters`` counted from
    zero; returns the model, params, engine, prompt, result, the launches
    and the prefill/decode seconds."""
    from repro_torch.models import build_model
    from repro_torch.serving import DecodeEngine
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device="cuda")
    engine = DecodeEngine(model, params, device="cuda")
    engine.generate(prompt[:, :64], 2)         # warm-up, not counted
    prefill_s = []
    real_prefill = model.prefill

    def timed_prefill(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_prefill(*args, **kw)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return out

    model.prefill = timed_prefill
    torch.cuda.synchronize()
    for counter in counters:
        counter.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.generate(prompt, gen_len)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {k: n for counter in counters
                for k, n in counter.launch_counts.items()}
    model.prefill = real_prefill
    return {"model": model, "params": params, "engine": engine,
            "prompt": prompt, "res": res, "launches": launches,
            "prefill_s": prefill_s[0], "decode_s": total - prefill_s[0]}


def serving_phase(torch, kern, kattn, ref):
    """qwen2-0.5b at full width in float32 and bfloat16, then reduced
    gemma3-12b; each held against the plain versions on the card.
    Returns the launches of each run and the throughputs."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config, reduced
    torch.cuda.reset_peak_memory_stats()
    base = dataclasses.replace(get_config("qwen2-0.5b"), use_kernels=True)
    layers = base.num_layers
    out = {"launches": {}, "throughput": {}}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
        label = f"qwen2-0.5b {dtype}"
        run = serve(torch, (kattn,), cfg, SERVE_BATCH, SERVE_PROMPT,
                    SERVE_GEN)
        res, eng, prompt = run["res"], run["engine"], run["prompt"]
        n = run["launches"]["flash_attention"]
        check(n == layers, f"{label}: flash_attention launched {n} times in "
              f"one prefill of {layers} layers")
        out["launches"][label] = n
        tp = {"prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
              "prefill_tok_per_s": SERVE_BATCH * SERVE_PROMPT
              / run["prefill_s"],
              "decode_tok_per_s": SERVE_BATCH * (SERVE_GEN - 1)
              / run["decode_s"],
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        out["throughput"][label] = tp
        print(f"serve {label}: batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
              f"{SERVE_GEN} tokens: prefill {tp['prefill_s']:.4f} s "
              f"({tp['prefill_tok_per_s']:.1f} tok/s), decode "
              f"{tp['decode_s']:.4f} s ({tp['decode_tok_per_s']:.1f} tok/s), "
              f"launches {run['launches']}", flush=True)
        check(np.isfinite(res.logprobs).all(),
              f"{label}: a log-probability is not finite")
        model, params = run["model"], run["params"]
        logits_k, _ = model.prefill(params, prompt, SERVE_PROMPT + 1)
        with plain_versions(kern, ref, kattn):
            kattn.reset_launch_counts()
            logits_p, _ = model.prefill(params, prompt, SERVE_PROMPT + 1)
            plain = eng.generate(prompt, SERVE_GEN) if dtype == "float32" \
                else None
            check(kattn.launch_counts["flash_attention"] == 0,
                  f"{label}: the plain-version run launched the kernel")
        check(bool(torch.isfinite(logits_k).all()),
              f"{label}: prefill logits are not finite")
        scale = float(logits_p.float().abs().max())
        diff = float((logits_k.float() - logits_p.float()).abs().max())
        print(f"serve {label}: prefill logits max |kernel - plain| {diff!r} "
              f"of max |logit| {scale!r}", flush=True)
        if dtype == "float32":
            check(diff <= PREFILL_RTOL * scale,
                  f"{label}: prefill logits differ by {diff} > "
                  f"{PREFILL_RTOL} * {scale}")
            same = int((res.tokens == plain.tokens).sum())
            check(same == res.tokens.size,
                  f"{label}: {res.tokens.size - same} generated tokens "
                  "differ from the plain versions'")
        else:
            tokens = torch.as_tensor(res.tokens, device="cuda")
            score_k = eng.score_continuation(prompt, tokens)
            with plain_versions(kern, ref, kattn):
                score_p = eng.score_continuation(prompt, tokens)
            d = float(np.abs(score_k - score_p).max())
            print(f"serve {label}: score_continuation kernel {score_k!r} "
                  f"plain {score_p!r} max |diff| {d!r}", flush=True)
            check(np.isfinite(score_k).all() and np.isfinite(score_p).all(),
                  f"{label}: a score is not finite")
            check(d <= SCORE_ATOL,
                  f"{label}: scores differ by {d} > {SCORE_ATOL}")
        del run, res, eng, prompt, model, params, logits_k, logits_p
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    label = "gemma3-12b reduced float32"
    cfg = reduced(get_config("gemma3-12b"), use_kernels=True)
    with recording_windows(kattn) as seen:
        run = serve(torch, (kattn,), cfg, 4, 40, 12)
    windows = seen[-cfg.num_layers:]
    n = run["launches"]["flash_attention"]
    check(n == cfg.num_layers and windows == [cfg.sliding_window, None],
          f"{label}: launches {n}, windows {windows}; want one launch on "
          "the local layer and one on the global one")
    with plain_versions(kern, ref, kattn):
        plain = run["engine"].generate(run["prompt"], 12)
    check((run["res"].tokens == plain.tokens).all(),
          f"{label}: tokens differ from the plain versions'")
    out["launches"][label] = n
    print(f"serve {label}: launches {n} (windows {windows}), tokens equal "
          "to the plain versions'", flush=True)
    return out


def ssd_inputs(torch, gen, bt, s, h, p, n, dtype):
    """x, dt, A, B, C of the SSD scan: normal x, B, C in ``dtype``,
    dt = softplus(normal) and A = -exp(normal / 2) in float32, as the
    reference's sweep draws them."""
    dt_ = getattr(torch, dtype)
    x = torch.randn((bt, s, h, p), generator=gen, device="cuda").to(dt_)
    dt = torch.nn.functional.softplus(
        torch.randn((bt, s, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.5)
    B = torch.randn((bt, s, n), generator=gen, device="cuda").to(dt_)
    C = torch.randn((bt, s, n), generator=gen, device="cuda").to(dt_)
    return x, dt, A, B, C


def ssd_work(bt, s, h, p, n, chunk):
    """Operations of the chunked scan on these shapes: per chunk of L
    positions, C B^T on the causal triangle (shared by the heads), and per
    head the triangle's product with x, C times the state and the state
    update."""
    ops = 0
    for s0 in range(0, s, chunk):
        ln = min(chunk, s - s0)
        tri = ln * (ln + 1) // 2
        ops += 2 * tri * n + h * (2 * tri * p + 4 * ln * p * n)
    return bt * ops


def ssd_design_bytes(bt, s, h, p, n, chunk):
    """The scratch traffic the kernel's passes add to the function's bytes
    (``ssd_scan.ssd_plan``): the chunk states written (chunk_state), read
    and written (state_pass) and read (chunk_scan); G written and read; cum
    written and read twice."""
    from repro_torch.kernels.ssd_scan import ssd_plan
    plan = ssd_plan(bt, s, h, p, n, chunk)
    return (4 * plan["states_bytes"] + 2 * plan["G_bytes"]
            + 3 * plan["cum_bytes"])


def ssm_kernel_phase(torch, kssd, krg, ref):
    """``ssd_scan`` and ``rglru_scan`` against their plain versions on the
    card at SSD_CASES (float32 and bfloat16), a strided-input case and
    RGLRU_CASES; kernel and plain version timed at the full-width shapes
    (SSD_TIMED, the last RG-LRU case), ``ssd_scan`` with the device time
    of each of its four launches.  Returns the two kernels' records."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    recs = {"ssd_scan": {"max_abs_err": 0.0,
                         "max_rel_err": {"float32": 0.0, "bfloat16": 0.0},
                         "timed": {}},
            "rglru_scan": {"max_abs_err": 0.0, "timed": {}}}
    rec = recs["ssd_scan"]
    for case in SSD_CASES:
        bt, s, h, p, n, chunk = case
        for dtype in ("float32", "bfloat16"):
            ins = ssd_inputs(torch, gen, bt, s, h, p, n, dtype)
            y = kssd.ssd_scan(*ins, chunk=chunk)
            want, _ = ref.ssd_ref(*ins)
            torch.cuda.synchronize()
            at = f"{case} {dtype}"
            check(y.dtype == ins[0].dtype and y.shape == ins[0].shape,
                  f"ssd_scan: wrong output {y.dtype} {tuple(y.shape)} at {at}")
            err = float((y.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            check(bool(torch.isfinite(y).all()) and rel < SSD_TOL[dtype],
                  f"ssd_scan differs from its plain version at {at}: max "
                  f"|diff| / max |plain| {rel}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_rel_err"][dtype] = max(rec["max_rel_err"][dtype], rel)
            print(f"ssd_scan {at}: max |kernel - plain| {err!r}, relative "
                  f"{rel!r}", flush=True)
            if case == SSD_TIMED:
                nbytes = sum(t.numel() * t.element_size() for t in ins) \
                    + y.numel() * y.element_size()
                ops = ssd_work(*case)
                rate = BF16_OPS_PER_S if dtype == "bfloat16" \
                    else F32_OPS_PER_S
                b_ms, b_by = bound_ms(nbytes, ops, rate)
                d_bytes = nbytes + ssd_design_bytes(*case)
                d_ms, d_by = bound_ms(d_bytes, ops, rate)
                t = {"shape": list(case), "dtype": dtype, "bytes": nbytes,
                     "ops": ops, "bound_ms": b_ms, "bound_by": b_by,
                     "design_bytes": d_bytes, "design_bound_ms": d_ms,
                     "design_bound_by": d_by,
                     "ms": time_ms(torch, lambda: kssd.ssd_scan(
                         *ins, chunk=chunk), 5),
                     "stages_ms": stage_ms(torch, lambda: kssd.ssd_scan(
                         *ins, chunk=chunk)),
                     "plain_ms": time_ms(torch, lambda: ref.ssd_ref(*ins), 1,
                                         reps=3, warmup=1),
                     "library_ms": None}
                rec["timed"][dtype] = t
                print(f"ssd_scan {at}: kernel {t['ms']:.5f} ms (by launch "
                      f"{t['stages_ms']}), plain {t['plain_ms']:.5f} ms, "
                      f"bound {b_ms:.5f} ms ({b_by}), this design's bound "
                      f"{d_ms:.5f} ms ({d_by}, {d_bytes} bytes)", flush=True)
            del ins, y, want
    # strided inputs: x, B and C as column slices of one projection, as
    # ssd_apply passes them; the kernel reads them in place
    bt, s, h, p, n, chunk = SSD_TIMED
    for dtype in ("float32", "bfloat16"):
        xbc = torch.randn((bt, s, h * p + 2 * n), generator=gen,
                          device="cuda").to(getattr(torch, dtype))
        xs, B, C = torch.split(xbc, [h * p, n, n], dim=-1)
        x = xs.reshape(bt, s, h, p)
        dt = torch.nn.functional.softplus(
            torch.randn((bt, s, h), generator=gen, device="cuda"))
        A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.5)
        y = kssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
        y_c = kssd.ssd_scan(x.contiguous(), dt, A, B.contiguous(),
                            C.contiguous(), chunk=chunk)
        want, _ = ref.ssd_ref(x, dt, A, B, C)
        torch.cuda.synchronize()
        rel = float((y.float() - want.float()).abs().max()) \
            / float(want.float().abs().max())
        check(torch.equal(y, y_c) and rel < SSD_TOL[dtype],
              f"ssd_scan on strided inputs ({dtype}): equal to contiguous "
              f"{torch.equal(y, y_c)}, relative difference {rel}")
        rec["max_rel_err"][dtype] = max(rec["max_rel_err"][dtype], rel)
        print(f"ssd_scan strided {SSD_TIMED} {dtype}: equal to the "
              f"contiguous inputs' result, relative {rel!r}", flush=True)
        del xbc, xs, B, C, x, y, y_c, want
    rec = recs["rglru_scan"]
    for case in RGLRU_CASES:
        # the model's gates: a in (0.9, 1) (layers.py:610-612, 629-630)
        a = torch.rand(case, generator=gen, device="cuda") * 0.099 + 0.9
        b = torch.randn(case, generator=gen, device="cuda")
        h = krg.rglru_scan(a, b)
        want, _ = ref.rglru_ref(a, b)
        torch.cuda.synchronize()
        err = float((h - want).abs().max())
        check(h.dtype == torch.float32 and h.shape == a.shape
              and bool(torch.allclose(h, want, atol=RGLRU_ATOL,
                                      rtol=RGLRU_RTOL)),
              f"rglru_scan differs from its plain version at {case}: max "
              f"|diff| {err}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"rglru_scan {case}: max |kernel - plain| {err!r}", flush=True)
        if case == RGLRU_CASES[-1]:
            n = a.numel()
            b_ms, b_by = bound_ms(12 * n, 2 * n)
            t = {"shape": list(case), "bytes": 12 * n, "ops": 2 * n,
                 "bound_ms": b_ms, "bound_by": b_by,
                 "ms": time_ms(torch, lambda: krg.rglru_scan(a, b), 5),
                 "plain_ms": time_ms(torch, lambda: ref.rglru_ref(a, b), 1,
                                     reps=3, warmup=1),
                 "library_ms": None}
            rec["timed"]["float32"] = t
            print(f"rglru_scan {case}: kernel {t['ms']:.5f} ms, plain "
                  f"{t['plain_ms']:.5f} ms, bound {b_ms:.5f} ms ({b_by})",
                  flush=True)
        del a, b, h, want
    torch.cuda.empty_cache()
    return recs


def _layer_launches(cfg):
    """The launches one full-sequence forward of ``cfg`` makes under
    use_kernels: one per layer of each kernel's kind."""
    kinds = cfg.layer_kinds
    return {"flash_attention": sum(k in ("global", "local") for k in kinds),
            "ssd_scan": kinds.count("ssd"),
            "rglru_scan": kinds.count("rglru")}


def ssm_forward_phase(torch, kern, kattn, kssd, krg, ref):
    """``DecoderLM.loss`` of mamba2-130m and recurrentgemma-2b at full width
    with use_kernels=True on SSM_BATCH x SSM_SEQ random tokens, float32 and
    bfloat16, held against the same call with the plain versions on the
    card.  Each is timed as the median of LOSS_REPS calls after a warm-up
    call at the same shape; the first timed call's launches are counted.
    Returns the launches of each run and the throughputs."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    counters = (kattn, kssd, krg)
    out = {"launches": {}, "throughput": {}}
    for arch in SSM_ARCHS:
        base = dataclasses.replace(get_config(arch), use_kernels=True)
        want = _layer_launches(base)
        for dtype in ("float32", "bfloat16"):
            label = f"{arch} {dtype} loss"
            cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
            model = build_model(cfg)
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = model.init(gen, device="cuda")
            toks = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_SEQ + 1),
                                 generator=gen, device="cuda")
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
            with torch.inference_mode():
                model.loss(params, batch)          # warm-up, full shape
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for counter in counters:
                    counter.reset_launch_counts()
                runs = []
                for rep in range(LOSS_REPS):
                    t0 = time.perf_counter()
                    loss_k, _ = model.loss(params, batch)
                    torch.cuda.synchronize()
                    runs.append(time.perf_counter() - t0)
                    if rep == 0:
                        launches = {k: n for counter in counters
                                    for k, n in counter.launch_counts.items()}
                secs = statistics.median(runs)
                peak = torch.cuda.max_memory_allocated() / 1e9
                logits_k = model.forward(params, batch["tokens"])[0] \
                    if dtype == "float32" else None
                with plain_versions(kern, ref, kattn, kssd, krg):
                    for counter in counters:
                        counter.reset_launch_counts()
                    loss_p, _ = model.loss(params, batch)
                    logits_p = model.forward(params, batch["tokens"])[0] \
                        if dtype == "float32" else None
                    check(not any(n for counter in counters
                                  for n in counter.launch_counts.values()),
                          f"{label}: the plain-version run launched a kernel")
            ce_k, ce_p = float(loss_k), float(loss_p)
            tp = {"seconds": secs, "runs_s": runs,
                  "tok_per_s": SSM_BATCH * SSM_SEQ / secs, "peak_gb": peak}
            out["throughput"][label] = tp
            out["launches"][label] = launches
            print(f"{label}: {SSM_BATCH} x {SSM_SEQ} tokens in {secs:.4f} s "
                  f"(median of {runs}; {tp['tok_per_s']:.1f} tok/s), peak "
                  f"{peak:.3f} GB, "
                  f"launches {launches}, CE kernels {ce_k!r} plain "
                  f"{ce_p!r}", flush=True)
            check(launches == want,
                  f"{label}: launches {launches}, want {want}")
            check(math.isfinite(ce_k) and math.isfinite(ce_p),
                  f"{label}: CE is not finite")
            if dtype == "float32":
                check(bool(torch.isfinite(logits_k).all()),
                      f"{label}: logits are not finite")
                scale = float(logits_p.abs().max())
                # row by row: the logits of recurrentgemma-2b take 8.4 GB
                diff = max(float((k - p).abs().max())
                           for k, p in zip(logits_k, logits_p))
                print(f"{label}: logits max |kernels - plain| {diff!r} of "
                      f"max |logit| {scale!r}", flush=True)
                check(diff <= PREFILL_RTOL * scale,
                      f"{label}: logits differ by {diff} > {PREFILL_RTOL} * "
                      f"{scale}")
                check(abs(ce_k - ce_p) <= CE_RTOL * abs(ce_p),
                      f"{label}: CE {ce_k} vs {ce_p} (relative {CE_RTOL})")
            else:
                check(abs(ce_k - ce_p) <= CE_ATOL_BF16,
                      f"{label}: CE {ce_k} vs {ce_p} (within {CE_ATOL_BF16})")
            del model, params, toks, batch, logits_k, logits_p, loss_k, loss_p
            torch.cuda.empty_cache()
    return out


def ssm_serving_phase(torch, kern, kattn, kssd, krg, ref):
    """mamba2-130m and recurrentgemma-2b at full width through
    ``DecodeEngine.generate`` with use_kernels=True, float32 and bfloat16:
    SSM_BATCH prompts of SSM_SEQ tokens and SSM_GEN greedy tokens.  The
    prefill launches flash attention on each local layer and no SSM kernel,
    as in the reference.  Float32 tokens must equal those of the plain
    versions' run; bfloat16 scores must agree to SCORE_ATOL."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    counters = (kattn, kssd, krg)
    out = {"launches": {}, "throughput": {}}
    for arch in SSM_ARCHS:
        base = dataclasses.replace(get_config(arch), use_kernels=True)
        want = dict(_layer_launches(base), ssd_scan=0, rglru_scan=0)
        for dtype in ("float32", "bfloat16"):
            label = f"{arch} {dtype} serve"
            cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
            torch.cuda.reset_peak_memory_stats()
            run = serve(torch, counters, cfg, SSM_BATCH, SSM_SEQ, SSM_GEN)
            res, eng, prompt = run["res"], run["engine"], run["prompt"]
            tp = {"prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
                  "prefill_tok_per_s": SSM_BATCH * SSM_SEQ / run["prefill_s"],
                  "decode_tok_per_s": SSM_BATCH * (SSM_GEN - 1)
                  / run["decode_s"],
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            out["throughput"][label] = tp
            out["launches"][label] = run["launches"]
            print(f"{label}: batch {SSM_BATCH}, prompt {SSM_SEQ}, {SSM_GEN} "
                  f"tokens: prefill {tp['prefill_s']:.4f} s "
                  f"({tp['prefill_tok_per_s']:.1f} tok/s), decode "
                  f"{tp['decode_s']:.4f} s ({tp['decode_tok_per_s']:.1f} "
                  f"tok/s), peak {tp['peak_gb']:.3f} GB, launches "
                  f"{run['launches']}", flush=True)
            check(run["launches"] == want,
                  f"{label}: launches {run['launches']}, want {want}")
            check(np.isfinite(res.logprobs).all(),
                  f"{label}: a log-probability is not finite")
            if dtype == "float32":
                with plain_versions(kern, ref, kattn, kssd, krg):
                    for counter in counters:
                        counter.reset_launch_counts()
                    plain = eng.generate(prompt, SSM_GEN)
                    check(not any(n for counter in counters
                                  for n in counter.launch_counts.values()),
                          f"{label}: the plain-version run launched a kernel")
                same = int((res.tokens == plain.tokens).sum())
                check(same == res.tokens.size,
                      f"{label}: {res.tokens.size - same} generated tokens "
                      "differ from the plain versions'")
                print(f"{label}: all {same} tokens equal to the plain "
                      "versions'", flush=True)
            else:
                tokens = torch.as_tensor(res.tokens, device="cuda")
                score_k = eng.score_continuation(prompt, tokens)
                with plain_versions(kern, ref, kattn, kssd, krg):
                    score_p = eng.score_continuation(prompt, tokens)
                d = float(np.abs(score_k - score_p).max())
                print(f"{label}: score_continuation kernels {score_k!r} "
                      f"plain {score_p!r} max |diff| {d!r}", flush=True)
                check(np.isfinite(score_k).all()
                      and np.isfinite(score_p).all(),
                      f"{label}: a score is not finite")
                check(d <= SCORE_ATOL,
                      f"{label}: scores differ by {d} > {SCORE_ATOL}")
            del run, res, eng, prompt
            torch.cuda.empty_cache()
    return out


def experiments_phase(torch, counted):
    """The paper's claims on the card: every main of
    ``repro_torch.experiments`` with its reference's asserts unchanged
    (fig3 and table2 at quick=False, fig3c, fig_e4 and fig_e8 at
    quick=True, table1 and plan_deployment on the host), one JSON line per
    main with its setting, result and wall seconds; table2's model time to
    75% (the paper's Table E.1 communication model) beside the card's own
    training seconds to the same step; ``steps_per_sec`` of
    ``two_level(8, 2, 16, 4)`` per step and through ``run_rounds`` (median
    of SPS_REPS); fig3's hsgd_N2 trajectory (seed 0) and fig3c's
    divergences, card against CPU.  ``counted`` are the kernel modules
    whose launch counts are read: this path runs no codec, so no kernel
    may launch.  Returns the phase's record."""
    from repro_torch.core import make_topology, two_level
    from repro_torch.core.divergence import all_divergences
    from repro_torch.experiments import (common, fig3_sandwich,
                                         fig3c_grouping, fig_e4_participation,
                                         fig_e8_multilevel, plan_deployment,
                                         table1_bounds, table2_time_to_acc)
    t_phase = time.perf_counter()
    for mod in counted:
        mod.reset_launch_counts()
    rec = {"mains": []}

    def run_main(name, fn, setting, device, why=None):
        t0 = time.perf_counter()
        try:
            result = fn()
        except AssertionError as e:
            raise SmokeFailure(f"{name} ({setting}): the claim failed on "
                               f"{device}") from e
        line = {"experiment": name, "setting": setting, "device": device,
                "wall_s": time.perf_counter() - t0, "result": result}
        if why:
            line["why"] = why
        print(json.dumps(line), flush=True)
        rec["mains"].append(line)
        return result

    def live(quick):
        return "quick=True" if quick else "quick=False (full)"

    run_main("fig3_sandwich",
                         lambda: fig3_sandwich.main(False, "cuda"),
                         live(False), "cuda")
    rows = run_main("table2_time_to_acc",
                    lambda: table2_time_to_acc.main(False, "cuda"),
                    live(False), "cuda")
    for name, mod in (("fig3c_grouping", fig3c_grouping),
                      ("fig_e4_participation", fig_e4_participation),
                      ("fig_e8_multilevel", fig_e8_multilevel)):
        run_main(name, lambda: mod.main(True, "cuda"), live(True), "cuda")
    run_main("table1_bounds", table1_bounds.main, "quick=True", "host")
    run_main("plan_deployment", plan_deployment.main, "the example's",
             "host")
    rec["table2"] = [{
        "config": r["config"], "final_acc": r["final_acc"],
        "model_ms_to_75%": r["time_to_75%_ms"],
        "card_s_to_75%": r["device_s_to_75%"],
        "card_s_at_T": r["device_s_at_T"]} for r in rows]
    for r in rec["table2"]:
        print(f"table2 {r['config']}: paper's Table E.1 communication "
              f"model {r['model_ms_to_75%']} ms to 75%; this card's "
              f"training wall {r['card_s_to_75%']} s to the same step "
              f"({r['card_s_at_T']} s for all 300 steps)", flush=True)
    check(all(r["card_s_to_75%"] is not None for r in rec["table2"]),
          "table2: a configuration never reached 75% on the card")

    ds, model = common.make_world(8)
    spec = two_level(*SPS_SPEC)
    sps = {}
    for label, use_rounds in (("step", False), ("run_rounds", True)):
        runs = [common.steps_per_sec(ds, model, spec, T=SPS_T,
                                     use_rounds=use_rounds, device="cuda")
                for _ in range(SPS_REPS)]
        sps[label] = {"median": statistics.median(runs), "runs": runs}
        print(f"steps_per_sec two_level{SPS_SPEC} T={SPS_T} {label}: "
              f"median {sps[label]['median']!r} of {runs}", flush=True)
    rec["steps_per_sec"] = sps

    topo = lambda: make_topology("two_level", n=8, N=2, G=16, I=4)
    T = 240
    card = common.trajectory(ds, model, topo(), T, seed=0, device="cuda")
    cpu = common.trajectory(ds, model, topo(), T, seed=0, device="cpu")
    rel = abs(card[-1]["loss"] - cpu[-1]["loss"]) / abs(cpu[-1]["loss"])
    print(f"fig3 hsgd_N2 seed 0, T={T}: final loss {card[-1]['loss']!r} "
          f"on cuda, {cpu[-1]['loss']!r} on cpu, relative difference "
          f"{rel!r}", flush=True)
    check(math.isfinite(card[-1]["loss"]) and rel <= LOSS_RTOL,
          f"fig3 hsgd_N2: card vs CPU final loss differ by {rel} relative "
          f"> {LOSS_RTOL}")
    rec["trajectory_card_vs_cpu"] = {
        "loss_cuda": card[-1]["loss"], "loss_cpu": cpu[-1]["loss"],
        "acc_cuda": card[-1]["acc"], "acc_cpu": cpu[-1]["acc"],
        "rel": rel}

    ds4, model4 = common.make_world(8, num_classes=4)
    grads, gs, on_cpu = fig3c_grouping.measured(ds4, model4,
                                                torch.device("cpu"))
    gcard = grads.to("cuda")
    divs = {}
    for k, g in gs.items():
        on_card = all_divergences(gcard, g)
        err = max(abs(on_card[m] - on_cpu[k][m]) for m in on_card)
        scale = max(abs(v) for v in on_cpu[k].values())
        divs[k] = {"cuda": on_card, "cpu": on_cpu[k], "rel": err / scale}
        print(f"fig3c divergences, {k} grouping: cuda {on_card} cpu "
              f"{on_cpu[k]}, max |diff| / max |cpu| {err / scale!r}",
              flush=True)
        check(err <= DIV_RTOL * scale,
              f"fig3c {k}: card vs CPU divergences differ by {err / scale} "
              f"of the largest > {DIV_RTOL}")
    rec["divergences_card_vs_cpu"] = divs

    launched = {k: v for mod in counted for k, v in mod.launch_counts.items()
                if v}
    check(not launched, f"the experiments launched kernels: {launched}")
    rec["wall_s"] = time.perf_counter() - t_phase
    if rec["wall_s"] > EXPERIMENTS_BUDGET_S:
        why = (f"the phase took {rec['wall_s']:.1f} s > "
               f"{EXPERIMENTS_BUDGET_S} s at the full setting")
        run_main("fig3_sandwich", lambda: fig3_sandwich.main(True, "cuda"),
                 live(True), "cuda", why)
        run_main("table2_time_to_acc",
                 lambda: table2_time_to_acc.main(True, "cuda"), live(True),
                 "cuda", why)
    return rec


# The runtime phase's codec runs in the quickstart world: (label, comms,
# EngineConfig fields, the kernels the run must launch).  A runtime is
# built per run (a factory), its clock per run_rounds call.
def _runtime_runs():
    from repro_torch.runtime import DeadlineElastic, RuntimeModel
    return (
        ("async int8", "int8", lambda: {"async_levels": {1: 1}},
         ("int8_scale_quantize",)),
        ("elastic int8", "int8", lambda: {"runtime": RuntimeModel(
            straggler="bursty:0.25:0.5:2.5", policy=DeadlineElastic(2.0))},
         ("int8_scale_quantize",)),
        ("async sign", "sign", lambda: {"async_levels": {1: 1}},
         ("sign_pack",)),
    )


def runtime_phase(torch, kern, ref):
    """The runtime twin's matrix on the card and on the CPU, the host cost
    of its three arms under two_level / bursty, and the quickstart world's
    codec runs through the async and elastic paths (see the module
    docstring, 11).  Returns the phase's record, with the kernels'
    launches per run under ``launches``."""
    from repro_torch.experiments import bench_runtime as br
    t_phase = time.perf_counter()
    rec = {"card": card_line()}
    reports = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        reports[device] = br.matrix(True, device)
        print(f"runtime twin matrix on {device}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    card, cpu = reports["cuda"], reports["cpu"]
    exact = ("steps_to_target", "time_to_target_s", "makespan_at_target_s",
             "total_sim_time_s", "final_sync_s", "dropped", "synced")
    rows = {}
    for tname, row in card["topologies"].items():
        for rname in br.REGIMES:
            for arm in ("full_barrier", "elastic", "async"):
                a, b = row[rname][arm], cpu["topologies"][tname][rname][arm]
                key = f"{tname}/{rname}/{arm}"
                rows[key] = {"best_acc_cuda": a["best_acc"],
                             "best_acc_cpu": b["best_acc"],
                             **{k: a[k] for k in exact}}
                diff = {k: (a[k], b[k]) for k in exact if a[k] != b[k]}
                check(not diff, f"runtime twin {key}: card vs CPU differ "
                      f"in {diff}")
            check(row[rname]["target_acc"]
                  == cpu["topologies"][tname][rname]["target_acc"],
                  f"runtime twin {tname}/{rname}: target accuracy differs")
    check(card["claims"] == cpu["claims"],
          f"runtime twin: the claims differ, card {card['claims']} vs CPU "
          f"{cpu['claims']}")
    false = [k for k, v in card["claims"].items() if not v["holds"]]
    check(false == RUNTIME_FALSE_CLAIMS,
          f"runtime twin: false claims {false}, want exactly "
          f"{RUNTIME_FALSE_CLAIMS} (the reference's own)")
    for key, v in card["claims"].items():
        print(f"runtime claim {key}: holds {v['holds']} "
              f"(compared {v['compared']})", flush=True)
    rec["twin"] = {"rows": rows, "claims": card["claims"]}

    ds, model = br.make_world(n_workers=8, num_classes=4)
    init = br.load_init_params()
    spec, links = br.TOPOLOGIES["two_level"]
    straggler = br.REGIMES["bursty"]
    host = {}
    for arm, deadline, al in (("full_barrier", None, None),
                              ("elastic", br.DEADLINE_S, None),
                              ("async", br.DEADLINE_S, br.STALE)):
        walls, sps = [], []
        for _ in range(RUNTIME_REPS):
            t0 = time.perf_counter()
            br.run_arm(ds, model, spec, links, straggler, deadline, 96,
                       async_levels=al, device="cuda", init_params=init)
            walls.append(time.perf_counter() - t0)
            _, _, run_s = br.run_arm(ds, model, spec, links, straggler,
                                     deadline, 96, eval_every=0,
                                     async_levels=al, device="cuda",
                                     init_params=init)
            sps.append(96 / run_s)
        host[arm] = {"wall_s": statistics.median(walls), "walls": walls,
                     "steps_per_s": statistics.median(sps), "runs": sps}
        print(f"runtime host cost two_level/bursty {arm}: wall "
              f"{host[arm]['wall_s']!r} s (of {walls}), run_rounds "
              f"{host[arm]['steps_per_s']!r} steps/s (of {sps}); "
              f"{rec['card']}", flush=True)
    rec["host_two_level_bursty"] = host

    launches, runs = {}, {}
    for label, comms, cfg, kernels in _runtime_runs():
        def run(device):
            return quickstart(device, comms, **cfg())
        gpu = run("cuda")
        with plain_versions(kern, ref):
            plain = run("cuda")
        cpu_run = run("cpu")
        rel = abs(gpu["loss"] - cpu_run["loss"]) / abs(cpu_run["loss"])
        dropped = None if gpu["runtime"] is None else \
            sum(gpu["runtime"]["dropped"].values())
        print(f"runtime path {label}: cuda loss {gpu['loss']!r} acc "
              f"{gpu['acc']!r} wire_bytes {gpu['wire_bytes']} launches "
              f"{gpu['launches']} dropped {dropped} {gpu['seconds']:.3f} s "
              f"| cuda plain versions loss {plain['loss']!r} | cpu loss "
              f"{cpu_run['loss']!r} wire_bytes {cpu_run['wire_bytes']} | "
              f"cuda vs cpu loss relative difference {rel!r}", flush=True)
        for name in kernels:
            check(gpu["launches"][name] > 0,
                  f"{label}: kernel {name} was never launched")
            launches.setdefault(name, {})[label] = gpu["launches"][name]
        check(not any(plain["launches"].values()),
              f"{label}: the plain-version run launched a kernel")
        check(all(torch.equal(a, b)
                  for a, b in zip(gpu["params"], plain["params"]))
              and gpu["loss"] == plain["loss"],
              f"{label}: the kernels' trajectory differs from the plain "
              "versions' on the card")
        check(math.isfinite(gpu["loss"]) and rel <= LOSS_RTOL,
              f"{label}: loss {gpu['loss']} on cuda vs {cpu_run['loss']} "
              f"on cpu, relative difference {rel} > {LOSS_RTOL}")
        check(gpu["wire_bytes"] == cpu_run["wire_bytes"] > 0,
              f"{label}: wire bytes {gpu['wire_bytes']} on cuda, "
              f"{cpu_run['wire_bytes']} on cpu")
        if gpu["runtime"] is not None:
            check(dropped > 0 and gpu["runtime"] == cpu_run["runtime"],
                  f"{label}: dropped {dropped} workers, runtime report "
                  f"{gpu['runtime']} on cuda vs {cpu_run['runtime']} on cpu")
        runs[label] = {"loss_cuda": gpu["loss"], "loss_cpu": cpu_run["loss"],
                       "rel": rel, "acc_cuda": gpu["acc"],
                       "wire_bytes": gpu["wire_bytes"], "dropped": dropped,
                       "launches": gpu["launches"],
                       "seconds": gpu["seconds"]}
    rec["runs"] = runs
    rec["launches"] = launches
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec


def _sync_warnings(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the synchronizing-call warnings it raised (every
    device-to-host copy and every wait for the device is one), each as
    the innermost Python frames that led to the call."""
    import traceback
    import warnings
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()
                      if Path(f.filename).name != "warnings.py"][:-1]
            sites.append(" < ".join(
                f"{'/'.join(Path(f.filename).parts[-2:])}:{f.lineno}"
                for f in reversed(frames[-SYNC_FRAMES:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def _kernel_census(torch, fn) -> dict:
    """CUDA kernels of one ``fn()`` call (``torch.profiler``): the
    ``cudaLaunchKernel`` calls the host made and the kernels the device
    recorded."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return {"host_launches": sum(e.name.startswith(("cudaLaunchKernel",
                                                    "cuLaunchKernel"))
                                 for e in events),
            "device_kernels": sum(
                e.device_type == torch.autograd.DeviceType.CUDA
                for e in events)}


def _obs_engine(spec, device, metrics="on", batch=OBS_BATCH, **cfg):
    """bench_obs's model on ``spec`` with ``metrics``, from the params of
    ``torch.Generator().manual_seed(0)``; returns the engine, its state and
    a batch function on bench_obs's data at ``batch`` per worker."""
    import torch
    from repro_torch.core import EngineConfig, HSGD, make_topology
    from repro_torch.experiments import bench_obs
    from repro_torch.optim import sgd
    ds, model = bench_obs.make_obs_world(n_workers=8)
    eng = HSGD(model.loss, sgd(OBS_LR), make_topology("uniform", spec=spec),
               EngineConfig(metrics=metrics, **cfg))
    st = eng.init(torch.Generator().manual_seed(0), model.init,
                  device=device)
    return eng, st, lambda t: ds.batch(t, batch)


def obs_phase(torch, kern, ref):
    """The observability layer on the card (see the module docstring, 12).
    Returns the phase's record, with the kernels' launches per run under
    ``launches``."""
    from repro_torch.core import Round, SyncEvent, compile_schedule
    from repro_torch.experiments import bench_obs
    from repro_torch.obs import TraceRecorder, validate_trace
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    rec = {"card": card_line()}

    # card against CPU, probes on, on bench_obs's two topologies
    parity = {}
    for tname, spec in bench_obs.TOPOLOGIES.items():
        hists, params = {}, {}
        for device in ("cuda", "cpu"):
            eng, st, batch = _obs_engine(spec, device)
            st, hists[device] = eng.run_rounds(st, batch, OBS_T)
            params[device] = [p.cpu() for p in tree_leaves(st.params)]
        card, cpu = hists["cuda"], hists["cpu"]
        rows = [(a, b) for a, b in zip(card, cpu) if "div_global" in b]
        check(len(rows) == OBS_T // spec.periods[-1]
              and all("div_global" in a for a, _ in rows),
              f"obs {tname}: probe rows on the card "
              f"{sum('div_global' in a for a in card)}, on the CPU "
              f"{len(rows)}, want one per sync")
        div_err = max(max(abs(a[k] - b[k]) for k in b if k.startswith("div_"))
                      / max(abs(b[k]) for k in b if k.startswith("div_"))
                      for a, b in rows)
        gn_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                     for a, b in zip(card, cpu))
        levels = sorted({int(k[len("div_up_L"):]) for k in cpu[-1]
                         if k.startswith("div_up_L")})
        eq10 = max(abs(a[f"div_up_L{lvl}"] + a[f"div_down_L{lvl}"]
                       - a["div_global"]) / a["div_global"]
                   for a, _ in rows for lvl in levels)
        print(f"obs {tname}: {len(rows)} probe rows; card vs CPU div_* "
              f"max |diff| / row max {div_err!r}, grad_norm max relative "
              f"{gn_err!r}; eq. (10) on the card max |up + down - global| "
              f"/ global {eq10!r}", flush=True)
        check(div_err <= DIV_RTOL, f"obs {tname}: card vs CPU probe rows "
              f"differ by {div_err} of the row's largest > {DIV_RTOL}")
        check(gn_err <= GRAD_NORM_RTOL, f"obs {tname}: grad_norm differs "
              f"by {gn_err} relative > {GRAD_NORM_RTOL}")
        check(eq10 <= DIV_RTOL, f"obs {tname}: eq. (10) misses by {eq10} "
              f"of div_global > {DIV_RTOL}")
        # probes change no param bit: the same run with metrics None
        eng, st, batch = _obs_engine(spec, "cuda", metrics=None)
        st, off = eng.run_rounds(st, batch, OBS_T)
        same = all(torch.equal(a.cpu(), b) for a, b in
                   zip(tree_leaves(st.params), params["cuda"]))
        check(same and st.metrics is None
              and [r["ce"] for r in off] == [r["ce"] for r in card],
              f"obs {tname}: probes on moved the trajectory on the card")
        parity[tname] = {"rows": len(rows), "div_rel": div_err,
                         "grad_norm_rel": gn_err, "eq10_rel": eq10,
                         "probes_off_bitwise": same}
    rec["card_vs_cpu"] = parity

    # host syncs and launches: one local round and one sync round of
    # two_level, probes on against off, after a warm-up period
    spec = bench_obs.TOPOLOGIES["two_level"]
    n_local = spec.periods[-1]
    engines = {name: _obs_engine(spec, "cuda", metrics=m)
               for name, m in (("on", "on"), ("off", None))}
    torch.cuda.synchronize()
    _, rec["sync_mode_switch"] = _sync_warnings(torch, lambda: None)
    costs = {}
    for name, (eng, st, batch) in engines.items():
        st, _ = eng.run_rounds(st, batch, spec.G)      # builds every round
        dev_batches = tuple(eng._on_device(batch(i), st)
                            for i in range(n_local))
        cost = {}
        for kind, rnd in (("local", Round(n_local, None)),
                          ("sync", Round(n_local, SyncEvent(level=2)))):
            fn = eng.round_fn(rnd)
            fn(st, dev_batches)                        # builds the body
            sites = []
            for _ in range(SYNC_CALLS):
                torch.cuda.synchronize()
                (st2, _), where = _sync_warnings(
                    torch, lambda: fn(st, dev_batches))
                sites.append(where)
            cost[kind] = {"syncs": [len(w) for w in sites],
                          "sync_sites": sites,
                          **_kernel_census(torch,
                                           lambda: fn(st, dev_batches))}
        if name == "on":
            torch.cuda.synchronize()
            (_, rows), where = _sync_warnings(
                torch, lambda: eng.drain_metrics(st2))
            cost["drain"] = {"syncs": len(where), "sync_sites": where,
                             "rows": len(rows)}
            leaves = len(tree_leaves(st.params))
            cost["op_budget_sim"] = eng.metrics.op_budget(
                "sim", eng.topology, leaves)
        costs[name] = cost
    on, off = costs["on"], costs["off"]
    extra = {kind: {k: on[kind][k] - off[kind][k]
                    for k in ("host_launches", "device_kernels")}
             for kind in ("local", "sync")}
    extra["per_local_step"] = {k: v / n_local
                               for k, v in extra["local"].items()}
    extra["sync_row"] = {k: extra["sync"][k] - extra["local"][k]
                         for k in extra["local"]}
    print(f"obs host syncs in each of {SYNC_CALLS} calls of a round, "
          f"probes on / off: local {on['local']['syncs']} / "
          f"{off['local']['syncs']}, sync {on['sync']['syncs']} / "
          f"{off['sync']['syncs']}; a drain of {on['drain']['rows']} "
          f"row(s): {on['drain']['syncs']} sync(s) at "
          f"{on['drain']['sync_sites']}; the first switch into the warn "
          f"mode: {rec['sync_mode_switch']}", flush=True)
    print(f"obs extra CUDA launches with probes on: per local step "
          f"{extra['per_local_step']}, per sync round {extra['sync']} (of "
          f"which the probe row {extra['sync_row']}); "
          f"Metrics.op_budget('sim') = {on['op_budget_sim']} (a jaxpr "
          f"count of the reference's, recorded, not asserted); "
          f"{rec['card']}", flush=True)
    check(on["local"]["syncs"] == off["local"]["syncs"]
          and on["sync"]["syncs"] == off["sync"]["syncs"],
          f"obs: probes on add host syncs to a round: {costs}")
    check(on["drain"]["syncs"] == 1 and on["drain"]["rows"] == 1,
          f"obs: a drain took {on['drain']['syncs']} host syncs for "
          f"{on['drain']['rows']} row(s), want exactly one")
    rec["syncs_and_launches"] = {"probes_on": on, "probes_off": off,
                                 "extra": extra}

    # the twin's timed leg on the card
    t0 = time.perf_counter()
    twin = bench_obs.run(quick=True, device="cuda")
    for tname, row in twin["topologies"].items():
        print(f"bench_obs {tname}: steps/s off {row['off']['steps_per_sec_all']}"
              f" on {row['on']['steps_per_sec_all']}, ratio per repeat "
              f"{row['ratio_all']}, best pair {row['ratio_best_pair']!r} "
              f"(min {bench_obs.MIN_RATIO}); {rec['card']}", flush=True)
        check(row["ratio_best_pair"] >= bench_obs.MIN_RATIO,
              f"bench_obs {tname}: probes-on keeps "
              f"{row['ratio_best_pair']} of probes-off steps/s on the best "
              f"same-repeat pair < {bench_obs.MIN_RATIO}")
    twin["wall_s"] = time.perf_counter() - t0
    rec["bench_obs"] = twin

    # the same pairs on a host-bound world: the paper's experiment world
    from repro_torch.core import two_level
    from repro_torch.experiments import common
    ds, model = common.make_world(8)
    host = {"off": [], "on": []}
    for _ in range(OBS_HOST_REPS):
        for name, metrics in (("off", None), ("on", "on")):
            host[name].append(common.steps_per_sec(
                ds, model, two_level(*SPS_SPEC), T=SPS_T, use_rounds=True,
                device="cuda", metrics=metrics))
    host["ratio_all"] = [a / b for a, b in zip(host["on"], host["off"])]
    print(f"obs on a host-bound world (two_level{SPS_SPEC}, T={SPS_T}, "
          f"run_rounds): steps/s off {host['off']} on {host['on']}, "
          f"ratio per repeat {host['ratio_all']} (not asserted); "
          f"{rec['card']}", flush=True)
    rec["host_bound_world"] = host

    # async int8 with the staleness channel, the quickstart world
    label = "async int8 probes"
    cfg = {"async_levels": {1: 1}, "metrics": "on"}
    gpu = quickstart("cuda", "int8", **cfg)
    with plain_versions(kern, ref):
        plain = quickstart("cuda", "int8", **cfg)
    cpu_run = quickstart("cpu", "int8", **cfg)
    off = quickstart("cuda", "int8", async_levels={1: 1})
    rel = abs(gpu["loss"] - cpu_run["loss"]) / abs(cpu_run["loss"])
    from repro_torch.core import make_topology
    topo = make_topology("two_level", n=8, N=2, G=16, I=4)
    folds, t = set(), 0
    for rnd in compile_schedule(topo.schedule(96), async_levels={1: 1}):
        t += rnd.n_local
        if rnd.stale and rnd.stale[-1].snapshot and rnd.stale[-1].n_fold:
            folds.add(t)
    stale = {r["t"]: r["div_staleness"] for r in gpu["history"]
             if "div_staleness" in r}
    print(f"obs {label}: cuda loss {gpu['loss']!r} | plain versions "
          f"{plain['loss']!r} | cpu {cpu_run['loss']!r}, relative "
          f"{rel!r}; launches {gpu['launches']}; staleness at folds "
          f"{[stale.get(t) for t in sorted(folds)]}, elsewhere max "
          f"{max(v for t, v in stale.items() if t not in folds)!r}",
          flush=True)
    check(gpu["launches"]["int8_scale_quantize"] > 0,
          f"{label}: int8_scale_quantize was never launched")
    check(not any(plain["launches"].values()),
          f"{label}: the plain-version run launched a kernel")
    check(all(torch.equal(a, b) for a, b in zip(gpu["params"],
                                                plain["params"]))
          and gpu["loss"] == plain["loss"]
          and gpu["history"] == plain["history"],
          f"{label}: the kernels' run differs from the plain versions'")
    check(all(torch.equal(a, b) for a, b in zip(gpu["params"],
                                                off["params"])),
          f"{label}: probes on moved the async int8 trajectory")
    check(math.isfinite(gpu["loss"]) and rel <= LOSS_RTOL,
          f"{label}: loss {gpu['loss']} on cuda vs {cpu_run['loss']} on "
          f"cpu, relative difference {rel} > {LOSS_RTOL}")
    check(gpu["wire_bytes"] == cpu_run["wire_bytes"] > 0,
          f"{label}: wire bytes {gpu['wire_bytes']} vs {cpu_run['wire_bytes']}")
    check(folds and set(stale) >= folds
          and all((v > 0) == (t in folds) for t, v in stale.items()),
          f"{label}: the staleness channel {stale} is not nonzero exactly "
          f"at the stale folds {sorted(folds)}")
    rec["async_int8"] = {"loss_cuda": gpu["loss"],
                         "loss_cpu": cpu_run["loss"], "rel": rel,
                         "wire_bytes": gpu["wire_bytes"],
                         "launches": gpu["launches"],
                         "staleness": {str(t): stale[t] for t in sorted(stale)}}
    rec["launches"] = {"int8_scale_quantize": {
        label: gpu["launches"]["int8_scale_quantize"]}}

    # the trace: python -m repro_torch.obs on the card and on the CPU
    names = {}
    for key, device in (("card", "cuda"), ("host", "cpu")):
        out = ROOT / "build" / f"obs_trace_{key}.json"
        check(obs_main(["--out", str(out), "--device", device]) == 0,
              f"python -m repro_torch.obs failed on {device}")
        trace = json.loads(out.read_text())
        if key == "card":
            errs = validate_trace(trace)
        names[key] = [e["name"] for e in trace["traceEvents"]]
    print(f"obs trace (python -m repro_torch.obs, runtime on): "
          f"{len(names['card'])} events on the card, {len(names['host'])} "
          f"on the CPU; validate_trace: {errs or 'valid'}", flush=True)
    check(not errs, f"obs trace: {errs[:5]}")
    check(names["card"] == names["host"],
          "obs trace: the card's event names differ from the CPU's")
    rec["trace"] = {"events": len(names["card"]), "valid": not errs,
                    "names_equal_cpu": True}
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec


def _pop_engine(device, comms=None, cells=POP_CELLS, **pop):
    """bench_population's world under the population regime; returns the
    engine, its server state (from ``torch.Generator().manual_seed(0)``),
    the batch function and the server's loss on a fixed eval batch."""
    import numpy as np
    import torch
    from repro_torch.core import EngineConfig, HSGD
    from repro_torch.experiments import bench_population as bp
    from repro_torch.population import Population
    from repro_torch.optim import sgd
    model, shards = bp.make_world()
    eng = HSGD(model.loss, sgd(bp.LR), bp._topology(), EngineConfig(
        comms=comms, population=Population(cells=cells, seed=bp.SEED, **pop)))
    server = eng.init_server(torch.Generator().manual_seed(0), model.init,
                             device=device)
    ev = shards.batch(np.arange(64), 10**6, 8)
    ev = {k: torch.as_tensor(v.reshape((-1,) + v.shape[2:]), device=device)
          for k, v in ev.items()}
    loss = lambda srv: float(model.loss(srv.params, ev)[0])
    return eng, server, bp.batch_fn(shards), loss


def population_phase(torch, kern, ref):
    """The population regime on the card (see the module docstring, 13).
    Returns the phase's record, with the kernels' launches per run under
    ``launches``."""
    from repro_torch.experiments import bench_population as bp
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    rec = {"card": card_line()}
    t0 = time.perf_counter()
    twin = bp.run(quick=True, device="cuda")
    twin["wall_s"] = time.perf_counter() - t0
    base = twin["baseline"]
    print(f"bench_population baseline (materialized n = k): "
          f"{base['time_per_step_s']!r} s per step, state "
          f"{base['state_bytes']} bytes; {rec['card']}", flush=True)
    for popsize, r in twin["sweep"].items():
        print(f"bench_population {popsize} clients (cells {r['cells']}): "
              f"{r['time_per_step_s']!r} s per step "
              f"({r['overhead_vs_baseline']!r}x the baseline), draw "
              f"{r['draw_ms_per_round']!r} ms per round, state "
              f"{r['state_bytes']} bytes, {r['unique_clients']} clients "
              f"seen", flush=True)
    check(twin["state_bytes_equal"],
          f"bench_population: hydrated state bytes "
          f"{ {r['state_bytes'] for r in twin['sweep'].values()} } are not "
          f"all the baseline's {bp.BASELINE_STATE_BYTES}")
    check(twin["bitwise_k_eq_population"],
          "bench_population: with k == population the sampled loop is not "
          "bit for bit the materialized engine on the card")
    rec["bench_population"] = twin

    # run_sampled under int8: kernels against plain versions, card vs CPU
    label = f"population int8 cells {POP_CELLS}"

    def sampled(device, comms):
        eng, server, batch, loss = _pop_engine(device, comms)
        kern.reset_launch_counts()
        server, hist = eng.run_sampled(server, batch, POP_ROUNDS)
        if device == "cuda":
            torch.cuda.synchronize()
        return {"loss": loss(server), "launches": dict(kern.launch_counts),
                "params": [p.cpu() for p in tree_leaves(server.params)],
                "wire_bytes": sum(h.get("wire_bytes", 0) for h in hist),
                "participation": [h["participation"] for h in hist]}

    gpu = sampled("cuda", "int8")
    with plain_versions(kern, ref):
        plain = sampled("cuda", "int8")
    cpu_run = sampled("cpu", "int8")
    rel = abs(gpu["loss"] - cpu_run["loss"]) / abs(cpu_run["loss"])
    print(f"{label}: server loss cuda {gpu['loss']!r} | plain versions "
          f"{plain['loss']!r} | cpu {cpu_run['loss']!r}, relative {rel!r}; "
          f"wire bytes {gpu['wire_bytes']} (cpu {cpu_run['wire_bytes']}); "
          f"launches {gpu['launches']}", flush=True)
    check(gpu["launches"]["int8_scale_quantize"] > 0,
          f"{label}: int8_scale_quantize was never launched")
    check(not any(plain["launches"].values()),
          f"{label}: the plain-version run launched a kernel")
    check(all(torch.equal(a, b) for a, b in zip(gpu["params"],
                                                plain["params"]))
          and gpu["loss"] == plain["loss"],
          f"{label}: the kernels' run differs from the plain versions'")
    check(math.isfinite(gpu["loss"]) and rel <= LOSS_RTOL,
          f"{label}: server loss {gpu['loss']} on cuda vs "
          f"{cpu_run['loss']} on cpu, relative {rel} > {LOSS_RTOL}")
    check(gpu["wire_bytes"] == cpu_run["wire_bytes"] > 0
          and gpu["participation"] == cpu_run["participation"],
          f"{label}: wire bytes or participation differ from the CPU run")
    rec["int8"] = {"loss_cuda": gpu["loss"], "loss_cpu": cpu_run["loss"],
                   "rel": rel, "wire_bytes": gpu["wire_bytes"],
                   "launches": gpu["launches"]}

    # top-k: the nonzero fold-back, card against CPU in server params
    # top-k: the nonzero fold-back of one round's slots, card against CPU
    # on the same inputs, then whole runs card against CPU in loss
    import dataclasses
    from repro_torch.tree import tree_map
    eng, server, batch, _ = _pop_engine("cpu", "topk")
    popeng = eng.population_engine()
    check(popeng.fold_mode == "nonzero", "population topk: the fold-back "
          f"mode is {popeng.fold_mode}, not nonzero")
    draw = popeng.sampler.draw(0)
    st, _ = popeng.inner.run_rounds(
        popeng.hydrate(server), lambda t: batch(draw.client_ids, t),
        popeng.round_steps)
    weights, _ = popeng.round_weights(draw)
    on_card = lambda tree: tree_map(lambda x: x.to("cuda"), tree)
    fold_cpu = popeng.fold_back(server, st, weights)
    fold_card = popeng.fold_back(
        dataclasses.replace(server, params=on_card(server.params),
                            opt_state=on_card(server.opt_state)),
        dataclasses.replace(st, params=on_card(st.params),
                            opt_state=on_card(st.opt_state)), weights)
    fold_err = max(float((a.cpu() - b).abs().max()
                         / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(tree_leaves(fold_card.params),
                                   tree_leaves(fold_cpu.params)))
    tk_card, tk_cpu = sampled("cuda", "topk"), sampled("cpu", "topk")
    tk_rel = abs(tk_card["loss"] - tk_cpu["loss"]) / abs(tk_cpu["loss"])
    gap = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(tk_card["params"], tk_cpu["params"]))
    print(f"population topk (nonzero fold) cells {POP_CELLS}: one round's "
          f"fold-back card vs CPU on the same slots, max |diff| / max |cpu| "
          f"per leaf {fold_err!r}; {POP_ROUNDS} rounds: server loss "
          f"{tk_card['loss']!r} / {tk_cpu['loss']!r}, relative {tk_rel!r}, "
          f"params max |diff| / max |cpu| per leaf {gap!r} (not held: "
          f"top-k selections near ties); launches {tk_card['launches']}",
          flush=True)
    check(fold_err <= POP_TOPK_RTOL, f"population topk: the fold-back "
          f"differs card vs CPU by {fold_err} relative > {POP_TOPK_RTOL}")
    check(math.isfinite(tk_card["loss"]) and tk_rel <= LOSS_RTOL,
          f"population topk: server loss {tk_card['loss']} on cuda vs "
          f"{tk_cpu['loss']} on cpu, relative {tk_rel} > {LOSS_RTOL}")
    check(tk_card["wire_bytes"] == tk_cpu["wire_bytes"] > 0
          and tk_card["participation"] == tk_cpu["participation"],
          "population topk: wire bytes or participation differ from the "
          "CPU run")
    check(not any(tk_card["launches"].values()),
          f"population topk: sim launched {tk_card['launches']}")
    rec["topk"] = {"fold_rel": fold_err, "loss_cuda": tk_card["loss"],
                   "loss_cpu": tk_cpu["loss"], "loss_rel": tk_rel,
                   "params_gap": gap, "wire_bytes": tk_card["wire_bytes"]}
    rec["launches"] = {"int8_scale_quantize": {
        label: gpu["launches"]["int8_scale_quantize"]}}
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec


def profile_phase(torch, kattn):
    """The serving profile (``--profile``); returns its numbers."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), use_kernels=True)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, device="cuda")
    max_len = SERVE_PROMPT + DECODE_STEPS + 4
    logits, cache = model.prefill(params, prompt, max_len)     # warm-up
    tok = logits.argmax(-1)
    for _ in range(2):
        logits, cache = model.decode_step(params, cache, tok)
    state = {}

    def prefill():
        state["logits"], state["cache"] = model.prefill(params, prompt,
                                                        max_len)

    def decode():
        tok = state["logits"].argmax(-1)
        state["logits"], state["cache"] = model.decode_step(
            params, state["cache"], tok)

    out = {}
    for label, fn, n in (("prefill", prefill, 1),
                         ("decode step", decode, DECODE_STEPS)):
        torch.cuda.synchronize()
        kattn.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / n
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        rec = {"kernels": len(kernels) / n, "device_busy_ms": busy_ms,
               "wall_ms": wall_ms,
               "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
               "flash_attention_launches": kattn.launch_counts[
                   "flash_attention"] / n,
               "top_host_ops": [(e.key, e.count / n,
                                 e.self_cpu_time_total / 1e3 / n)
                                for e in top[:8]]}
        out[label] = rec
        print(f"profile {label} (per call, {n} calls): "
              f"{rec['kernels']:.1f} CUDA kernels, device busy "
              f"{busy_ms:.4f} ms of {wall_ms:.4f} ms wall, idle share "
              f"{rec['idle_share']}, flash_attention launches "
              f"{rec['flash_attention_launches']}", flush=True)
        for key, count, ms in rec["top_host_ops"]:
            print(f"    {key}: {count:.1f} calls, {ms:.4f} ms host",
                  flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch under {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import comms as kern
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as krg
    from repro_torch.kernels import ssd_scan as kssd

    # TF32 rule: float32 products and convolutions in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--profile"]:
        print(card_line(), flush=True)
        _build.build("flash_attention")
        print(json.dumps({"profile": profile_phase(torch, kattn)}))
        return 0
    try:
        print(card_line(), flush=True)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            libs = list(pool.map(
                lambda name: _build.build(name, verbose=True), SOURCES))
        print(f"built {', '.join(str(lib.relative_to(ROOT)) for lib in libs)}"
              f" in {time.perf_counter() - t0:.1f} s", flush=True)
        sass = {name: sass_census(lib) for name, lib in zip(SOURCES, libs)
                if name in ("flash_attention", "topk_reduce", "ssd_scan")}
        print(f"SASS census: {sass}", flush=True)
        attn_fns = sass["flash_attention"]["functions"]
        check(any("split_planes" in f for f in attn_fns)
              and sum("_kernel" in f for f in attn_fns) == 13,
              f"flash_attention's library holds {sorted(attn_fns)}: want "
              "the split pre-pass and six bf16 and six f32 instantiations")
        for f, c in attn_fns.items():
            check("split_planes" in f or (c["HGMMA"] > 0
                                          and c["UTMALDG"] > 0),
                  f"flash_attention's {f} has no HGMMA or no UTMALDG: a "
                  "float32 or bfloat16 call could reach a kernel off the "
                  "tensor cores")
        check(sass["topk_reduce"]["global float atomics"] == 0
              and sass["topk_reduce"]["global CAS"] == 0,
              "topk_reduce's library has global float atomics or CAS")
        check(sass["ssd_scan"]["HMMA"] > 0 and sass["ssd_scan"]["HGMMA"] == 0
              and sass["ssd_scan"]["UTMALDG"] == 0,
              "ssd_scan's library has no HMMA (mma.sync), or HGMMA or "
              "UTMALDG")
        recs = kernel_phase(torch, kern, ref)
        recs.update(sign_kernel_phase(torch, kern, ref))
        for name, rec in recs.items():
            for shape in SHAPES:
                t = rec[shape]
                print(f"{name} {shape}: kernel {t['ms']:.5f} ms, plain "
                      f"{t['plain_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms",
                      flush=True)
        launches = main_path_phase(torch, kern, ref)
        topk = topk_kernel_phase(torch, kern, ref)
        topk_sim = topk_sim_phase(torch)
        mesh = mesh_phase(torch)
        attn = attention_kernel_phase(torch, kattn, ref)
        served = serving_phase(torch, kern, kattn, ref)
        ssm = ssm_kernel_phase(torch, kssd, krg, ref)
        ssm_fwd = ssm_forward_phase(torch, kern, kattn, kssd, krg, ref)
        ssm_served = ssm_serving_phase(torch, kern, kattn, kssd, krg, ref)
        experiments = experiments_phase(torch, (kern, kattn, kssd, krg))
        runtime = runtime_phase(torch, kern, ref)
        obs = obs_phase(torch, kern, ref)
        population = population_phase(torch, kern, ref)
        for phase in (runtime, obs, population):
            for name, by_run in phase["launches"].items():
                launches[name].update(by_run)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, source, replaces in (
            ("int8_quantize", "int8_codec", 68),
            ("int8_dequantize", "int8_codec", 94),
            ("int8_scale_quantize", "int8_codec", 120),
            ("sign_pack", "sign_codec", 194),
            ("sign_unpack", "sign_codec", 229)):
        rec = recs[name]
        big, small = rec[SHAPES[1]], rec[SHAPES[0]]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE.format(source),
            "replaces": f"{TPU_KERNEL}:{replaces}",
            "launches": sum(launches[name].values()),
            "launches_by_run": launches[name],
            "max_abs_err": rec["max_abs_err"],
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": None, "shape": list(SHAPES[1]),
            "block": SIGN_BLOCK if source == "sign_codec" else BLOCK,
            "main_path_shape": {"shape": list(SHAPES[0]), **small},
        })
    topk_runs = {f"mesh {label} (each of {MESH_WORKERS} ranks)":
                 rec["launches_per_rank"]["topk_decode_reduce"]
                 for label, rec in mesh["runs"].items()
                 if "topk_decode_reduce" in rec["launches_per_rank"]}
    kernels.append({
        "name": "topk_decode_reduce", "route": "cuda",
        "source": SOURCE.format("topk_reduce"), "replaces": TOPK_TPU_KERNEL,
        "launches": MESH_WORKERS * sum(topk_runs.values()),
        "launches_by_run": topk_runs,
        "max_abs_err": topk["max_abs_err"],
        "max_abs_err_repeated": topk["max_abs_err_repeated"],
        "ms": topk["ms"], "plain_ms": topk["plain_ms"],
        "bound_ms": topk["bound_ms"], "bound_by": topk["bound_by"],
        "library_ms": topk["library_ms"], "library": "index_add_",
        "shape": topk["shape"],
    })
    a, b, c = attn["timed"]

    # launches of each LM kernel, by run: serving, then the SSM loss and
    # serving runs
    def runs_of(name):
        return {label: c[name] for runs in (ssm_fwd, ssm_served)
                for label, c in runs["launches"].items() if c[name]}

    attn_runs = {**served["launches"], **runs_of("flash_attention")}
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": SOURCE.format("flash_attention"),
        "replaces": ATTN_TPU_KERNEL,
        "launches": sum(attn_runs.values()),
        "launches_by_run": attn_runs,
        "max_abs_err": attn["max_abs_err"],
        "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"], "library_ms": a["library_ms"],
        "bound_6d_ms": a["bound_6d_ms"], "bound_8d_ms": a["bound_8d_ms"],
        "f32_core_ms": a["f32_core_ms"],
        "shape": a["shape"], "shape_b": b, "shape_c": c,
        "max_abs_err_f32": attn["max_abs_err_f32"],
        "f32_ulps_max": attn["f32_ulps_max"], "f32_ulps_limit": ATTN_F32_ULPS,
        "float32": dict(zip("abc", attn["timed_f32"])),
        "launches_by_dtype": {
            dt: sum(n for label, n in attn_runs.items() if dt in label)
            for dt in ("float32", "bfloat16")},
        "serving": served["throughput"],
    })
    for name, replaces, timed in (
            ("ssd_scan", SSD_TPU_KERNEL, "bfloat16"),
            ("rglru_scan", RGLRU_TPU_KERNEL, "float32")):
        rec, by_run = ssm[name], runs_of(name)
        t = rec["timed"][timed]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE.format(name),
            "replaces": replaces, "launches": sum(by_run.values()),
            "launches_by_run": by_run, "max_abs_err": rec["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": t["shape"], "dtype": timed,
            "timed": rec["timed"],
            **({"max_rel_err": rec["max_rel_err"]} if name == "ssd_scan"
               else {}),
        })
    print(json.dumps({"ssm": {"loss": ssm_fwd["throughput"],
                              "serving": ssm_served["throughput"]}}))
    print(json.dumps({"topk_sim": topk_sim, "mesh": mesh}))
    print(json.dumps({"experiments": {k: v for k, v in experiments.items()
                                      if k != "mains"}}))
    print(json.dumps({"runtime": {k: v for k, v in runtime.items()
                                  if k != "launches"}}))
    print(json.dumps({"obs": {k: v for k, v in obs.items()
                              if k != "launches"}}))
    print(json.dumps({"population": {k: v for k, v in population.items()
                                     if k != "launches"}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
