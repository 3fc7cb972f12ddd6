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
   and sim.  In the same launch, the runtime, async, probe and population
   paths on the mesh (``_mesh_a7d_runs``): exact and production elastic
   int8 (a bursty runtime with ``DeadlineElastic(2.0)``, which must drop
   workers), exact async int8 ``{1: 1}`` and sign ``{2: 1}``, production
   async top-k ``{1: 1}``, exact async int8 and production int8 with
   probes on, and an exact population at MESH_POP_CELLS under int8 for
   MESH_POP_ROUNDS rounds: exact runs bit for bit the card's sim (params,
   residuals, pending slots, loss; the population's server), production
   runs within MESH_ATOL and LOSS_RTOL, every rank's ``sim_time_s`` and
   ``dropped`` history equal to the sim's, probe rows within
   MESH_PROBE_RTOL relative of the sim's (the gap printed) and the params
   bit for bit the probes-off run's, every rank's state, rows and draws the
   same, ``int8_scale_quantize`` / ``sign_pack`` launched on every rank
   and ``topk_decode_reduce`` exactly once per wire sync (fresh or
   posted) on every rank.  Then the twins' mesh legs through their entry
   points, each in its own launch of eight gloo ranks on the card:
   ``bench_runtime.matrix(backend="mesh", steps=MESH_TWIN_STEPS)`` (every
   regime's ``elastic_mesh`` and bursty's ``async_mesh``, which the twin
   holds to its sim arms) and ``bench_population.run(quick=False,
   backend="mesh")`` (the 10^6-client point, server bit for bit the
   sim's); steps/s of rank 0 beside the sim's printed, not asserted;
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
9a. MoE and encoder-decoder phase: at full width with
   ``use_kernels=True``, random weights from seed 0, olmoe-1b-7b (64
   experts top-8; float32 and bfloat16) and seamless-m4t-large-v2 (24 +
   24 layers, MOE_PROMPT // 4 stub audio frames a request; float32 and
   bfloat16) served through ``DecodeEngine.generate`` (MOE_BATCH prompts
   of MOE_PROMPT tokens, MOE_GEN greedy tokens) and scored by ``loss``
   (MOE_BATCH x MOE_PROMPT tokens, the median of LOSS_REPS calls after a
   warm-up), and mixtral-8x22b cut to MIXTRAL_LAYERS layers (float32, one
   prompt of MIXTRAL_PROMPT tokens, MIXTRAL_GEN tokens): one
   ``flash_attention`` launch per causal self-attention layer in every
   prefill and ``loss`` (16, 2 with the 4,096 window, 24; none in decode,
   the encoder or the cross-attention).  Against the plain versions on the
   card: float32 tokens equal, prefill logits within PREFILL_RTOL of the
   largest, CE within CE_RTOL, on the sequences without a router flip
   (each run's flips counted and printed); bfloat16 CE within
   CE_ATOL_BF16; olmoe's ``moe_dispatch="gather"`` loss within
   GATHER_RTOL of the einsum path's; tokens/s and peak GB printed;
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
10a. examples phase: the twins of the JAX package's ``examples/``
   (``repro_torch.examples``) through their ``main``s on the card, one
   JSON line each with its setting, device, wall seconds and result:
   quickstart, multilevel_hsgd and population_hsgd on the card and the
   CPU (losses and accuracy within LOSS_RTOL, clients seen equal, no
   kernel launched); serve_decode per arch (gemma3-12b, mamba2-130m,
   recurrentgemma-2b, seamless-m4t-large-v2, reduced, float32) with the
   kernels and with the plain versions on the card: greedy tokens equal,
   one ``flash_attention`` launch per causal self-attention layer of the
   prefill; train_hsgd with the reference's argv but fresh
   ``--ckpt-dir`` and ``--out`` (EXAMPLES_DIR): ``int8_scale_quantize``
   once per wire sync and int8 bucket, the checkpoints of steps 60 and
   120, ``sim_time_s`` in every step record;
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
   (``torch.profiler``), beside ``Metrics.op_budget("sim")`` (which counts
   reduces, not launches; the analysis phase enforces it).  The twin ``repro_torch.experiments.bench_obs``'s
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
14. train phase: H-SGD training of the LMs through
   ``repro_torch.launch.train.main``.  (a) qwen2-0.5b at full width
   (TRAIN_ARGV: 4 replicas in 2 groups, G=4, I=2, batch 4 x seq 256 a
   worker, int8 wire, 8 steps) with checkpoints every TRAIN_CKPT_EVERY
   steps under ``torch.use_deterministic_algorithms``: every loss finite,
   ``int8_scale_quantize`` launched once per sync and int8 bucket, the
   plain versions' run and a run resumed from the step-4 file (in a
   directory holding only it) bit for bit the kernels' run (step-8
   checkpoint and losses), an op without a deterministic CUDA version a
   failure; steps/s and tok/s over TRAIN_SPEED_STEPS steps with the
   default algorithms and no checkpoints (host clock, a ``synchronize``
   at the window's two ends only, the first round left out), peak GB,
   checkpoint GB and write and read GB/s printed.  (b) the same flags
   with ``--reduced`` on the card and the CPU for int8, sign, a runtime
   with a lognormal straggler and a deadline, probes and a population:
   losses and ``div_*`` within TRAIN_REDUCED_RTOL, the step-8
   checkpoints' params within TRAIN_REDUCED_ATOL (sign: its card-CPU gap
   printed, its kernels' run bit for bit its plain versions' run on the
   card), wire, clock, drop and participation fields equal,
   ``sign_pack`` launched once per sync.  (c) ``--backend
   mesh --comms topk`` at reduced size on TRAIN_MESH_WORKERS gloo ranks:
   ``topk_decode_reduce`` once per sync on every rank, records within
   MESH_ATOL of the sim's.  (d) ``launch.serve --ckpt-dir`` on a params
   checkpoint written on the card: greedy tokens equal to the same params'
   in memory.  (e) qwen2-0.5b at full width at 4,096 tokens a sequence
   (the chunked attention, each chunk rematerialized), remat off and on
   (see the note at TRAIN_LONG): peak GB and steps/s, the first step's CE
   bit for bit, a float32 gradient within REMAT_RTOL of the largest;
15. analysis phase: the audit of ``repro_torch.analysis`` on the card
   (see the note at ANALYSIS_BUDGET_S).  The matrix's nine sim configs
   audited on the card with the kernels equal their CPU audits with the
   plain versions field for field, each sync event's kernel regions equal
   the launch counters of one recorded sync, and each distinct round body
   raises no synchronizing-call warning under
   ``torch.cuda.set_sync_debug_mode("warn")`` (R3's zero); the six mesh
   configs and ``bench_obs``'s static leg run in one launch of eight gloo
   ranks on the card; the fifteen reports pass the check against
   ``ANALYSIS_budget_torch.json`` with no waiver.  ``launch.train
   --audit`` at TRAIN_ARGV's full width: each event's ops and payload
   and the WireStats bytes beside their prediction.  The twin of
   ``benchmarks/bench_comms.py`` with its wall-clock legs on the card:
   the static asserts hold, and the two wall-clock bounds are printed and
   recorded whatever they read;
15a. roofline phase: the port's cost model (``repro_torch.roofline``)
   against the card (see the note at ROOFLINE_REPS).  PERF.md's kernel
   bounds from the kernels' work counts (KERNEL_BOUNDS_MS); qwen2-0.5b's
   prefill at full width in float32 and bfloat16 (24 ``flash_attention``
   regions a call, equal to the launch counter), the local, local-sync
   and global-sync steps of TRAIN_ARGV's training (one
   ``int8_scale_quantize`` region a sync, equal to the counter) and their
   amortized period (``combine_train_steps``), and the quickstart world's
   global int8 round: FLOPs by class, bytes, the three terms, the bound,
   the measured time (median of ROOFLINE_REPS after a warm-up) and the
   share, each bound at most its measurement; the reduced training and
   ``loss`` reports equal card against CPU; the records in
   ``experiments.roofline_table``'s format written to ROOFLINE_OUT and
   rendered by it;
15b. dryrun phase: rank 0's program of the port's dry run
   (``repro_torch.launch.dryrun``) on the card, under torch's fake process
   group of 256 ranks (see the note at DRYRUN_ARCH): ``flash_attention``
   against its plain version at DRYRUN_SLICE (float32 and bfloat16);
   qwen2-0.5b's prefill_32k with the kernel in bfloat16 (the config's
   dtype) and float32 (its attention regions priced by the kernel's
   design) and decode_32k, rank 0's shards
   materialized on the card, each priced on the card and on ``meta`` (the
   reports equal), its bound at most its measurement, the kernel's
   launches equal its regions; train_4k on both meshes recorded on
   ``meta`` by child processes meanwhile; the four records written to
   DRYRUN_OUT and rendered by ``experiments.roofline_table``;
15c. hillclimb phase: the hillclimb's twin
   (``repro_torch.experiments.hillclimb``) for qwen2-0.5b|train_4k on the
   card's torch, one child process an iteration, started with the
   roofline phase (see the note at HILLCLIMB_PAIR): every iteration
   recorded,
   the bf16 sync's bytes half the f32 sync's, dp_only's params whole;
16. writes the records below, with the card's line, to
   ``chiprun_out/chip_smoke.json``, then prints one ``{"ssm": ...}`` JSON
   line with the SSM throughputs, one ``{"moe_encdec": ...}`` line, one
   ``{"topk_sim": ..., "mesh": ...}`` line, one ``{"experiments": ...}``
   line, one ``{"examples": ...}`` line, one ``{"runtime": ...}`` line,
   one ``{"obs": ...}`` line, one ``{"population": ...}`` line, one ``{"train": ...}`` line, one
   ``{"analysis": ...}`` line, one ``{"roofline": ...}`` line, one
   ``{"dryrun": ...}`` line, one ``{"hillclimb": ...}`` line, one
   ``{"kernels": [...]}`` JSON line (all
   nine kernels), then the result line ``{"ok": true, "device": {...}}``
   last.

Any failed phase exits non-zero before the result line.

    python3 chip_smoke.py --phase analysis,obs

builds every kernel and runs only the named phases (comma-separated, in
the order above: kernels, main_path, topk_kernel, topk_sim, mesh,
attention, serving, ssm_kernel, ssm_forward, ssm_serving, moe_encdec,
experiments, examples, runtime, obs, population, train, analysis, roofline,
dryrun, hillclimb), writes their
records to ``chiprun_out/chip_smoke_phases.json``, prints one JSON line
per phase and the result line last.  The ``kernels`` line needs every
phase, so it is printed only by a run without ``--phase``.

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
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's rates: one definition, the port's cost model's
from repro_torch.roofline.analysis import HW, work_bound  # noqa: E402

H100 = HW()
SOURCES = ("int8_codec", "sign_codec", "flash_attention", "ssd_scan",
           "rglru_scan", "topk_reduce")
BLOCK = 256
SHAPES = ((8, 2120), (8, 2**24 + 77))
SIGN_BLOCK = 1024
# (shape, block) of the sign kernel checks; the first two are timed
SIGN_CASES = (((8, 2120), SIGN_BLOCK), ((8, 2**24 + 77), SIGN_BLOCK),
              ((8, 2120), 64), ((8, 2120), 1000), ((8, 2120), 24))
HBM_BYTES_PER_S = H100.hbm_bw
F32_OPS_PER_S = H100.f32_flops
BF16_OPS_PER_S = H100.peak_flops
# flash attention cases: (B, Sq, Sk, Hq, Hk, D, dtype, causal, window);
# (a), (b), (c) and (d), the first ATTN_TIMED, are timed
ATTN_CASES = (
    (8, 1024, 1024, 14, 2, 64, "bfloat16", True, None),    # (a) qwen2 prefill
    (1, 2048, 2048, 16, 8, 256, "bfloat16", True, 1024),   # (b) gemma3 local
    (8, 1024, 1024, 10, 1, 256, "bfloat16", True, 2048),   # (c) recurrentgemma
    (8, 1024, 1024, 16, 16, 128, "bfloat16", True, None),  # (d) olmoe prefill
    # mixtral-8x22b's heads (48 over 8) and a window shorter than S
    (1, 1100, 1100, 48, 8, 128, "bfloat16", True, 700),
    (1, 1100, 1100, 48, 8, 128, "float32", True, 700),
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
ATTN_TIMED = 4
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
# of the ratio within a turn (best runs and medians printed beside).  One
# call's ratios spread from 0.76 to 1.23 (PERF.md §6, PR 23), a standard
# error of ~2.4% for the median of 32 turns, so it takes 64
DENSE_FORM_TURNS = 64
DENSE_FORM_MIN_RATIO = 0.95
# the runtime twin's mesh leg runs cut in depth to pay for the roofline
# and dryrun phases: MESH_TWIN_STEPS steps for 96 (48 from the roofline
# phase on, 24 from the dryrun phase on; the runtime phase runs the full
# matrix on the sim); every arm and every regime still runs, and each mesh
# arm is still held to its sim arm
MESH_TWIN_STEPS = 24
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
# the examples phase: the twins of the JAX package's examples/ through
# their main()s on the card; quickstart, multilevel and population card
# against CPU within LOSS_RTOL relative (population's clients seen
# equal), serve_decode's greedy tokens with the kernels equal to the
# plain versions' on the card, train_hsgd's run into fresh paths under
# EXAMPLES_DIR (removed after)
EXAMPLES_DIR = ROOT / "build" / "examples_phase"
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
# train phase: H-SGD training of the LMs through repro_torch.launch.train.
# (a) qwen2-0.5b at full width (configs/qwen2_0_5b.py: 494,032,768
# params, bf16), 4 replicas, checkpoints every TRAIN_CKPT_EVERY steps,
# under torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG is set
# in main() before CUDA starts): the kernels' run, the plain versions' run
# and a resume from the step-4 file must agree bit for bit, and an op of
# the path without a deterministic CUDA version (it warns) fails the
# phase.  Then the speed: TRAIN_SPEED_STEPS steps with the default
# algorithms and no checkpoints, the host clock read after a synchronize
# at the window's two ends only.  (b) the same flags with --reduced (f32)
# on the card and the CPU for each of TRAIN_REDUCED: losses and div_*
# within TRAIN_REDUCED_RTOL relative (PERF.md §6: sound runs read 7.6e-8
# to 1.5e-7, card and CPU started from other params 5e-4 to 7e-4), the
# step-8 checkpoints' params within TRAIN_REDUCED_ATOL, the wire, clock,
# drop and participation fields equal.  Sign's params are held by its
# kernels' run on the card against its plain versions' run there, bit for
# bit (a sign flip between card and CPU moves a param by a whole step);
# their card-CPU gap is printed.  Population mode takes no --ckpt-dir: its
# losses and fields only.  (c) --backend mesh --comms topk at reduced size
# on TRAIN_MESH_WORKERS gloo ranks, within MESH_ATOL of the sim.  (d)
# launch.serve --ckpt-dir on a params checkpoint written on the card.  The
# phase should add under TRAIN_BUDGET_S (printed, not asserted)
TRAIN_ARGV = ("--arch", "qwen2-0.5b", "--workers", "4", "--groups", "2",
              "--G", "4", "--I", "2", "--steps", "8", "--batch", "4",
              "--seq", "256", "--comms", "int8", "--log-every", "1")
TRAIN_CKPT_EVERY = 4
TRAIN_SPEED_STEPS = 24
TRAIN_PARAMS = 494_032_768
TRAIN_REDUCED_RTOL, TRAIN_REDUCED_ATOL = 1e-5, 1e-5
TRAIN_REDUCED = (
    ("int8", ()),
    ("sign", ("--comms", "sign")),
    ("runtime", ("--runtime", "0.004,0.005:1e9,0.0003:1e10",
                 "--straggler", "lognormal:0.8", "--deadline", "0.004")),
    ("probes", ("--probes",)),
    ("population", ("--population", "10x10", "--sample-k", "4")),
)
TRAIN_MESH_WORKERS = 4
TRAIN_BUDGET_S = 180.0
# (e) qwen2-0.5b at full width at train_4k's 4,096 tokens a sequence, one
# sequence a worker.  Every attention layer runs the chunked plain path
# (4,096 > attn_chunk_q = 512), each chunk rematerialized, so no chunk's
# float32 probabilities (0.94 GB a layer a sequence) are kept for the
# backward.  In the config's bfloat16, 2 of TRAIN_ARGV's 4 workers (at 4,
# and at 2 before the recompute was detached from torch.func.grad's
# tape, the remat-off step ran out of the card's 80 GB, PERF.md §6):
# TRAIN_LONG_STEPS local steps with remat off and then on from the
# same params, under torch.use_deterministic_algorithms, the first step's
# CE bit for bit (the forward is the same), peak GB beside
# TRAIN_LONG_PEAK_GB and steps/s of the last step printed.  Held as the
# CPU tests hold remat (tests/test_torch_remat.py): in float32, one
# worker's ``torch.func.grad`` of ``loss`` at the same params, remat on
# against off, within REMAT_RTOL of the largest entry (bit for bit where
# it is, printed); a bfloat16 gradient would round a 1e-7 difference to
# whole ulps of 2^-8
TRAIN_LONG = ("--workers", "2", "--batch", "1", "--seq", "4096")
TRAIN_LONG_STEPS = 2
TRAIN_LONG_PEAK_GB = {"remat off": (45.0, 70.0), "remat on": (15.0, 28.0)}
REMAT_RTOL = 1e-6
# the MoE and encoder-decoder phase, at full width: olmoe-1b-7b (f32 and
# bf16: MOE_BATCH prompts of MOE_PROMPT tokens, MOE_GEN greedy tokens, and
# loss on MOE_BATCH x MOE_PROMPT tokens; 4 MoE groups of 2048 tokens a
# layer, capacity 320 a group, which drops tokens), mixtral-8x22b cut to
# MIXTRAL_LAYERS of its 56 layers (f32, one prompt of MIXTRAL_PROMPT
# tokens: 3 groups, and its 4,096-token window shorter than the prompt)
# and seamless-m4t-large-v2 (f32 and bf16, prompt_len // 4 stub frames a
# request).  Held against the plain versions on the card: f32 greedy
# tokens equal, prefill logits within PREFILL_RTOL of the largest, CE
# within CE_RTOL; bf16 CE within CE_ATOL_BF16.  A token whose router
# probabilities tie within rounding picks another expert set under the
# kernel than under the plain version; such flips are counted and
# printed, and the f32 checks hold the sequences without one (a flip in
# a prefill group marks the whole group: capacity couples its tokens).
# moe_dispatch="gather" once in f32: loss within GATHER_RTOL of the einsum
# path's.  The phase should take under MOE_ENCDEC_BUDGET_S (printed)
MOE_BATCH, MOE_PROMPT, MOE_GEN = 8, 1024, 32
MIXTRAL_LAYERS, MIXTRAL_PROMPT, MIXTRAL_GEN = 2, 6144, 8
GATHER_RTOL = 1e-5
MOE_ENCDEC_BUDGET_S = 150.0
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
    """Least time for a design's work: the larger of bytes over the memory
    rate and operations over ``ops_per_s`` (default: the float32 rate)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def work_ms(work):
    """Least time for a kernel's function (its ``*_work`` count): ms and
    what bounds it, "bytes" or "operations"."""
    s, by = work_bound(work, H100)
    return s * 1e3, by


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

        work = {   # (kernel call, plain call, the function's work)
            "int8_quantize": (
                lambda: kern.int8_quantize(x, block=BLOCK),
                lambda: ref.int8_ref(x, BLOCK),
                kern.int8_quantize_work(r, c, BLOCK)),
            "int8_dequantize": (
                lambda: kern.int8_dequantize(q_k, s_k, block=BLOCK),
                lambda: ref.int8_dequant_ref(q_k, s_k, BLOCK),
                kern.int8_dequantize_work(r, c, BLOCK)),
            "int8_scale_quantize": (
                lambda: kern.int8_scale_quantize(x, group, block=BLOCK),
                lambda: ref.int8_scale_quant_ref(x, group, BLOCK),
                kern.int8_scale_quantize_work(r, c, BLOCK)),
        }
        inner = 50 if r * c < 1 << 20 else 1
        for name, (fk, fp, w) in work.items():
            b_ms, b_by = work_ms(w)
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
            work = {   # (kernel call, plain call, the function's work)
                "sign_pack": (
                    lambda: kern.sign_pack(x, block=block),
                    lambda: ref.sign_pack_ref(x, block),
                    kern.sign_pack_work(r, c, block)),
                "sign_unpack": (
                    lambda: kern.sign_unpack(bits, scale, size=c,
                                             block=block),
                    lambda: ref.sign_unpack_ref(bits, scale, c, block),
                    kern.sign_unpack_work(r, c, block)),
            }
            inner = 50 if r * c < 1 << 20 else 1
            for name, (fk, fp, w) in work.items():
                b_ms, b_by = work_ms(w)
                recs[name][(r, c)] = {
                    "ms": time_ms(torch, fk, inner),
                    "plain_ms": time_ms(torch, fp, inner),
                    "bound_ms": b_ms, "bound_by": b_by}
        del x, bits, scale, y
        torch.cuda.empty_cache()
    return recs


def quickstart_world(device: str, comms, spec=None, opt=None,
                     executor=None, **cfg):
    """The quickstart world's engine (see :func:`quickstart`), its initial
    state on ``device``, its dataset and its model."""
    import torch
    from repro_torch.core import (EngineConfig, HSGD, HierarchySpec,
                                  make_topology)
    from repro_torch.data import (FederatedDataset, label_shard_partition,
                                  make_classification)
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
    return engine, state, ds, model


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
    from repro_torch.kernels import comms as kern
    engine, state, ds, model = quickstart_world(device, comms, spec, opt,
                                                executor, **cfg)
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
            "pending": None if state.pending is None else
            pending_leaves(gather(state.pending)),
            "history": history}


def pending_leaves(pending):
    """The tensors of pending stale slots ({level: StaleSlot}) on the CPU,
    slot by slot, field by field."""
    from repro_torch.tree import tree_leaves
    out = []
    for lvl in sorted(pending):
        slot = pending[lvl]
        for snap in slot.snaps:
            for field in ("params", "opt", "agg", "agg_opt"):
                out += [t.cpu() for t in tree_leaves(getattr(snap, field))]
        if slot.residual is not None:
            out += [t.cpu() for t in tree_leaves(slot.residual)]
    return out


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
            w = kern.topk_decode_reduce_work(m, k, size)
            nbytes = w.bytes
            b_ms, b_by = work_ms(w)
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


# The mesh phase's runs of the runtime, async, probe and population paths
# (A7d), in the same launch: (label, comms, EngineConfig fields, exact, the
# kernels every rank must launch).  Exact runs must be the card's sim bit
# for bit (params, residuals, pending slots, loss), production runs within
# MESH_ATOL and LOSS_RTOL; "probes" runs are held to their probes-off twin
# (MESH_PROBES_OFF) bit for bit in params and to the sim's probe rows
# within MESH_PROBE_RTOL
def _mesh_a7d_runs():
    from repro_torch.comms import Comms
    from repro_torch.runtime import DeadlineElastic, RuntimeModel

    def elastic():
        return {"runtime": RuntimeModel(straggler="bursty:0.25:0.5:2.5",
                                        policy=DeadlineElastic(2.0))}
    return (
        ("exact elastic int8", lambda: "int8", elastic, True,
         ("int8_scale_quantize",)),
        ("elastic int8", lambda: "int8", elastic, False,
         ("int8_scale_quantize",)),
        ("exact async int8", lambda: "int8",
         lambda: {"async_levels": {1: 1}}, True, ("int8_scale_quantize",)),
        ("exact async sign", lambda: "sign",
         lambda: {"async_levels": {2: 1}}, True, ("sign_pack",)),
        ("async topk", lambda: Comms("topk", rate=TOPK_RATE),
         lambda: {"async_levels": {1: 1}}, False, ("topk_decode_reduce",)),
        ("exact async int8 probes", lambda: "int8",
         lambda: {"async_levels": {1: 1}, "metrics": "on"}, True,
         ("int8_scale_quantize",)),
        ("probes int8", lambda: "int8", lambda: {"metrics": "on"}, False,
         ("int8_scale_quantize",)),
    )


MESH_PROBES_OFF = {"exact async int8 probes": "exact async int8",
                   "probes int8": "int8"}
MESH_PROBE_PAIRS = 3             # probes off / on runs timed in turns
MESH_PROBE_RTOL = 1e-4           # tests/test_obs.py: sim vs mesh rows
MESH_POP_CELLS, MESH_POP_ROUNDS = (2, 4), 8


def count_collectives():
    """Count every collective this process's ``MeshAxes`` run (those over
    at least one axis) from now on: returns the counter, a dict whose
    ``"n"`` the caller resets."""
    from repro_torch.launch import mesh as lm
    counts = {"n": 0}
    reduce, gather = lm.MeshAxes._reduce, lm.MeshAxes.all_gather

    def counted_reduce(self, t, op):
        counts["n"] += bool(self.names)
        return reduce(self, t, op)

    def counted_gather(self, t):
        counts["n"] += bool(self.names)
        return gather(self, t)
    lm.MeshAxes._reduce, lm.MeshAxes.all_gather = \
        counted_reduce, counted_gather
    return counts


def _clock(history):
    return [(r.get("sim_time_s"), r.get("dropped")) for r in history]


def _rows(history):
    return [{k: v for k, v in r.items() if k.startswith("div_")}
            for r in history if "div_global" in r]


def wire_syncs(spec, async_levels, T=96):
    """The syncs that go through the codec's wire in a run of the
    quickstart world: one per fresh sync and one per posted (snapshot)
    stale sync."""
    from repro_torch.core import (HierarchySpec, compile_schedule,
                                  make_topology)
    topo = make_topology("two_level", n=8, N=2, G=16, I=4) if spec is None \
        else make_topology(HierarchySpec(*spec))
    n = 0
    for rnd in compile_schedule(topo.schedule(T),
                                async_levels=async_levels or None):
        if rnd.event is not None:
            n += sum(op.snapshot for op in rnd.stale)
            n += not (rnd.stale and rnd.stale[-1].snapshot)
    return n


def population_run(device, executor=None):
    """``run_sampled`` of bench_population's world at MESH_POP_CELLS under
    int8 for MESH_POP_ROUNDS rounds, on the sim or ``executor``: server
    loss and params, the draws, launches and seconds."""
    import torch
    from repro_torch.kernels import comms as kern
    from repro_torch.tree import tree_leaves
    eng, server, batch, loss = _pop_engine(device, "int8", MESH_POP_CELLS,
                                           executor=executor)
    popeng = eng.population_engine()
    draws = [popeng.sampler.draw(r).client_ids.tolist()
             for r in range(MESH_POP_ROUNDS)]
    kern.reset_launch_counts()
    t0 = time.perf_counter()
    server, hist = eng.run_sampled(server, batch, MESH_POP_ROUNDS)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"loss": loss(server), "draws": draws, "seconds": seconds,
            "steps_per_s": MESH_POP_ROUNDS * popeng.round_steps / seconds,
            "launches": dict(kern.launch_counts),
            "params": [p.cpu() for p in tree_leaves(server.params)],
            "participation": [h["participation"] for h in hist]}


def _digest(run) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in run["params"] + (run.get("comms") or []) + \
            (run.get("pending") or []):
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
    collectives = count_collectives()
    for label, make, spec, exact, _ in _mesh_runs():
        collectives["n"] = 0
        run = quickstart(device, make(), spec,
                         executor=MeshExecutor(exact=exact))
        run["collectives"] = collectives["n"]
        out[label] = run
        summary[label] = (run["launches"], run["seconds"], _digest(run))
    for label, make, cfg, exact, _ in _mesh_a7d_runs():
        collectives["n"] = 0
        run = quickstart(device, make(), executor=MeshExecutor(exact=exact),
                         **cfg())
        run["collectives"] = collectives["n"]
        out[label] = run
        summary[label] = (run["launches"], run["seconds"], _digest(run),
                          _clock(run["history"]), _rows(run["history"]))
    # the probes' host cost on the mesh: production int8 off / on in turns
    out["probe pairs"] = [
        [quickstart(device, "int8", executor=MeshExecutor(),
                    **({"metrics": "on"} if on else {}))["steps_per_s"]
         for on in (False, True)] for _ in range(MESH_PROBE_PAIRS)]
    run = population_run(device, MeshExecutor(exact=True))
    out["exact population"] = run
    summary["exact population"] = (run["launches"], run["seconds"],
                                   _digest(run), run["draws"])
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
    out["a7d"] = mesh_a7d_checks(torch, res, device)
    out["launches"] = out["a7d"].pop("launches")
    out["twins"] = mesh_twins(device)
    return out


def mesh_a7d_checks(torch, res, device: str):
    """The runs of ``_mesh_a7d_runs()`` and the exact population from the
    mesh launch ``res``, against the same runs on the card's sim (see the
    module docstring, 4c).  Returns their record, with the kernels'
    launches per run, summed over the ranks, under ``launches``."""
    out, launches = {"runs": {}}, {}
    mesh_runs = {label: (make, cfg, exact, kernels)
                 for label, make, cfg, exact, kernels in _mesh_a7d_runs()}
    for label, (make, cfg, exact, kernels) in mesh_runs.items():
        mesh = res["runs"][label]
        ranks = [r[label] for r in res["ranks"]]
        sim = quickstart(device, make(), **cfg())
        diff = max(float((a - b).abs().max())
                   for a, b in zip(mesh["params"], sim["params"]))
        rel = abs(mesh["loss"] - sim["loss"]) / abs(sim["loss"])
        al = cfg().get("async_levels")
        syncs = wire_syncs(None, al)
        per_rank = {k: [r[0][k] for r in ranks] for k in ranks[0][0]}
        rec = {"loss": mesh["loss"], "sim_loss": sim["loss"],
               "acc": mesh["acc"], "max_abs_params_diff": diff,
               "loss_rel": rel, "seconds": mesh["seconds"],
               "steps_per_s": mesh["steps_per_s"],
               "sim_seconds": sim["seconds"],
               "sim_steps_per_s": sim["steps_per_s"],
               "wire_syncs": syncs,
               "launches_per_rank": {k: v for k, v in per_rank.items()
                                     if any(v)}}
        check(len({r[2] for r in ranks}) == 1,
              f"mesh {label}: the ranks gathered different states")
        check(all(r[3] == _clock(sim["history"]) for r in ranks),
              f"mesh {label}: a rank's sim_time_s / dropped history differs "
              "from the sim's")
        check(mesh["wire_bytes"] == sim["wire_bytes"],
              f"mesh {label}: wire bytes {mesh['wire_bytes']} vs sim "
              f"{sim['wire_bytes']}")
        if sim["runtime"] is not None:
            dropped = sum(sim["runtime"]["dropped"].values())
            rec["dropped"] = dropped
            check(dropped > 0 and mesh["runtime"] == sim["runtime"],
                  f"mesh {label}: dropped {dropped}, runtime report "
                  f"{mesh['runtime']} vs sim {sim['runtime']}")
        for name in kernels:
            want = syncs if name == "topk_decode_reduce" else None
            check(all(n > 0 for n in per_rank[name]) and
                  (want is None or per_rank[name] == [want] * MESH_WORKERS),
                  f"mesh {label}: {name} launched {per_rank[name]} times on "
                  f"the ranks (want {want or 'at least once'} on each)")
            if name != "topk_decode_reduce":   # listed per rank, in main
                launches.setdefault(name, {})[
                    f"mesh {label} ({MESH_WORKERS} ranks)"] = \
                    sum(per_rank[name])
        if "topk_decode_reduce" not in kernels:
            check(not any(per_rank["topk_decode_reduce"]),
                  f"mesh {label}: topk_decode_reduce launched")
        if exact:
            same = all(torch.equal(a, b)
                       for a, b in zip(mesh["params"], sim["params"]))
            for key in ("comms", "pending"):
                check((mesh[key] is None) == (sim[key] is None),
                      f"mesh {label}: {key} present on one side only")
                same = same and all(torch.equal(a, b) for a, b in zip(
                    mesh[key] or [], sim[key] or []))
            same = same and mesh["loss"] == sim["loss"]
            rec["bitwise"] = same
            check(same, f"mesh {label}: exact mode is not the sim bit for "
                  f"bit (max |params diff| {diff})")
        else:
            check(diff < MESH_ATOL, f"mesh {label}: params differ from "
                  f"sim by {diff} >= {MESH_ATOL}")
            check(rel <= LOSS_RTOL, f"mesh {label}: loss {mesh['loss']} vs "
                  f"sim {sim['loss']}, relative difference {rel}")
        rows = _rows(mesh["history"])
        if rows:
            want = _rows(sim["history"])
            gap = max(abs(m[k] - w[k]) / max(abs(w[k]), 1e-8)
                      for m, w in zip(rows, want) for k in w)
            stale = [r.get("div_staleness", 0.0) for r in rows]
            rec.update(probe_rows=len(rows), probe_max_rel_gap=gap,
                       staleness_nonzero=sum(v > 0 for v in stale))
            # one row per sync event
            check(len(rows) == len(want) == wire_syncs(None, None) and
                  all(set(m) == set(w) for m, w in zip(rows, want)),
                  f"mesh {label}: {len(rows)} probe rows vs the sim's "
                  f"{len(want)}")
            check(gap <= MESH_PROBE_RTOL, f"mesh {label}: probe rows "
                  f"differ from the sim's by {gap} relative")
            check(all(r[4] == rows for r in ranks),
                  f"mesh {label}: the ranks' probe rows differ")
            if al:
                check(rec["staleness_nonzero"] > 0,
                      f"mesh {label}: the staleness channel never read a "
                      "fold")
            off = res["runs"][MESH_PROBES_OFF[label]]
            rec["bitwise_probes_off"] = all(
                torch.equal(a, b) for a, b in zip(mesh["params"],
                                                  off["params"]))
            # collectives the probes add, per sync event, on rank 0
            rec["extra_collectives_per_sync"] = \
                (mesh["collectives"] - off["collectives"]) / len(rows)
            check(rec["bitwise_probes_off"], f"mesh {label}: params differ "
                  f"from the probes-off run {MESH_PROBES_OFF[label]}")
        print(f"mesh {label}: loss {mesh['loss']!r} acc {mesh['acc']!r} "
              f"{mesh['steps_per_s']:.1f} steps/s on rank 0 | sim on the "
              f"card loss {sim['loss']!r} {sim['steps_per_s']:.1f} steps/s "
              f"| max |params diff| {diff!r}"
              + (f" | probe rows max relative gap {rec['probe_max_rel_gap']!r}"
                 f", staleness nonzero at {rec['staleness_nonzero']} syncs, "
                 f"{rec['extra_collectives_per_sync']!r} collectives more "
                 "per sync than probes off" if rows else "")
              + (f" | dropped {rec['dropped']}" if "dropped" in rec else "")
              + f" | launches per rank {rec['launches_per_rank']} "
              f"({syncs} wire syncs)", flush=True)
        out["runs"][label] = rec

    pairs = res["runs"]["probe pairs"]
    ratios = [on / off for off, on in pairs]
    out["probe_pairs_steps_per_s"] = pairs
    out["probe_ratio_median"] = statistics.median(ratios)
    print(f"mesh probes' host cost, production int8 on rank 0, steps/s "
          f"(off, on) in turns: {pairs}; on / off {ratios}, median "
          f"{out['probe_ratio_median']!r} (printed, not asserted)",
          flush=True)

    label = "exact population"
    mesh, ranks = res["runs"][label], [r[label] for r in res["ranks"]]
    sim = population_run(device)
    per_rank = [r[0]["int8_scale_quantize"] for r in ranks]
    same = mesh["loss"] == sim["loss"] and all(
        torch.equal(a, b) for a, b in zip(mesh["params"], sim["params"]))
    print(f"mesh {label} cells {MESH_POP_CELLS} int8, {MESH_POP_ROUNDS} "
          f"rounds: server loss {mesh['loss']!r} (sim {sim['loss']!r}), "
          f"bit for bit {same}; {mesh['steps_per_s']:.1f} steps/s on rank 0 "
          f"| sim {sim['steps_per_s']:.1f} steps/s | int8_scale_quantize "
          f"per rank {per_rank}", flush=True)
    check(same, f"mesh {label}: the server is not the sim's bit for bit")
    check(len({r[2] for r in ranks}) == 1
          and all(r[3] == sim["draws"] for r in ranks),
          f"mesh {label}: the ranks' servers or draws differ")
    check(mesh["participation"] == sim["participation"],
          f"mesh {label}: participation differs from the sim's")
    check(all(n > 0 for n in per_rank),
          f"mesh {label}: int8_scale_quantize launched {per_rank} times")
    launches["int8_scale_quantize"][
        f"mesh {label} ({MESH_WORKERS} ranks)"] = sum(per_rank)
    out["runs"][label] = {
        "loss": mesh["loss"], "sim_loss": sim["loss"], "bitwise": same,
        "steps_per_s": mesh["steps_per_s"],
        "sim_steps_per_s": sim["steps_per_s"],
        "launches_per_rank": {"int8_scale_quantize": per_rank}}
    out["launches"] = launches
    return out


def mesh_twins(device: str):
    """The twins' mesh legs through their entry points: the runtime matrix
    at MESH_TWIN_STEPS steps (the 8 ``elastic_mesh`` and 2 ``async_mesh``
    arms) and the population sweep (quick=False) with its 10^6-client mesh
    leg; each in its own launch of eight gloo ranks on the card, held by
    the twin itself to its sim arms (the twin raises otherwise).  Returns
    their steps/s beside the sim's."""
    from repro_torch.experiments import bench_population as bp
    from repro_torch.experiments import bench_runtime as br
    out = {"runtime": {}}
    t0 = time.perf_counter()
    report = br.matrix(True, device, backend="mesh", steps=MESH_TWIN_STEPS)
    out["runtime_wall_s"] = time.perf_counter() - t0
    for tname, row in report["topologies"].items():
        for rname in br.REGIMES:
            for arm in ("elastic_mesh", "async_mesh"):
                if arm not in row[rname]:
                    continue
                rec = row[rname][arm]
                key = f"{tname}/{rname}/{arm}"
                sim_arm = row[rname][arm[:-len("_mesh")]]
                for field in ("steps_to_target", "time_to_target_s",
                              "total_sim_time_s", "dropped", "synced"):
                    check(rec[field] == sim_arm[field],
                          f"bench_runtime {key}: {field} {rec[field]} vs "
                          f"the sim arm's {sim_arm[field]}")
                out["runtime"][key] = {
                    k: rec[k] for k in ("steps_per_s", "sim_steps_per_s",
                                        "max_abs_ce_diff_vs_sim",
                                        "time_to_target_s")}
                tt, sim_tt = (float(r["time_to_target_s"])
                              for r in (rec, sim_arm))
                print(f"bench_runtime {key}: {rec['steps_per_s']:.1f} "
                      f"steps/s on rank 0, sim {rec['sim_steps_per_s']:.1f} "
                      f"steps/s; time to target {tt!r} s (sim's {sim_tt!r})"
                      f", max |ce diff| {rec['max_abs_ce_diff_vs_sim']!r}",
                      flush=True)
    check(len(out["runtime"]) == len(br.TOPOLOGIES) * (len(br.REGIMES) + 1),
          f"bench_runtime mesh leg ran {sorted(out['runtime'])}: want every "
          "regime's elastic_mesh and bursty's async_mesh")
    t0 = time.perf_counter()
    pop = bp.run(quick=False, device=device, backend="mesh")
    out["population_wall_s"] = time.perf_counter() - t0
    m = pop["mesh"]
    print(f"bench_population mesh leg ({m['population']} clients, cells "
          f"{m['cells']}, {pop['rounds']} rounds): {m['time_per_step_s']!r} "
          f"s per step on rank 0, sim {m['sim_time_per_step_s']!r}; bit for "
          f"bit {m['params_bitwise_vs_sim']}, ranks agree "
          f"{m['ranks_agree']}", flush=True)
    check(m["params_bitwise_vs_sim"] and m["ranks_agree"],
          "bench_population mesh leg: the exact mesh's server is not the "
          "sim's bit for bit on every rank")
    check(pop["bitwise_k_eq_population"] and pop["state_bytes_equal"],
          "bench_population (quick=False): a sim proof failed")
    out["population"] = m
    print(f"mesh twins: runtime matrix and mesh leg "
          f"{out['runtime_wall_s']:.1f} s, population sweep and mesh leg "
          f"{out['population_wall_s']:.1f} s", flush=True)
    return out


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
    pairs = kattn.visible_pairs(sq, sk, causal, window)
    w = kattn.flash_attention_work(b, sq, sk, hq, hk, d, q.dtype, causal,
                                   window)
    # the function's products (4*D a visible pair), whatever the design
    flops, nbytes = 4 * b * hq * d * pairs, w.bytes
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
    t["bound_ms"], t["bound_by"] = work_ms(w)
    if dtype == "bfloat16":
        t["bound_6d_ms"] = bound_ms(nbytes, flops * 3 // 2,
                                    BF16_OPS_PER_S)[0]
        t["bound_8d_ms"] = bound_ms(nbytes, flops * 2, BF16_OPS_PER_S)[0]
        extra = (f" at 4*D, {t['bound_6d_ms']:.5f} ms at 6*D, "
                 f"{t['bound_8d_ms']:.5f} ms at 8*D")
    else:
        split, launch = w.stages
        t["split_bound_ms"] = work_ms(split)[0]
        launch_ms = work_ms(launch)[0]
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
        if i < ATTN_TIMED:
            rec["timed"].append(
                attention_timing(torch, kattn, ref, q, k, v, want, at)[0])
        del q, k, v, out, want
        torch.cuda.empty_cache()
        if i < ATTN_TIMED:
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


def serve(torch, counters, cfg, batch, prompt_len, gen_len, seed=0,
          frames=0, record=contextlib.nullcontext):
    """``cfg`` at random weights through ``DecodeEngine.generate`` on the
    card, the launches of every wrapper module in ``counters`` counted from
    zero; an encoder-decoder gets ``frames`` stub frames a request, drawn
    after the prompt.  The counted run is made inside ``record()``.
    Returns the model, params, engine, prompt, frames (or None), result,
    what ``record()`` yielded, the launches, the prefill's last logits and
    the prefill/decode seconds."""
    from repro_torch.models import build_model
    from repro_torch.models.frontends import synth_audio_frames
    from repro_torch.serving import DecodeEngine
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device="cuda")
    enc = synth_audio_frames(gen, cfg, batch, frames) if frames else None
    engine = DecodeEngine(model, params, device="cuda")
    engine.generate(prompt[:, :64], 2, enc_inputs=enc)   # warm-up
    prefill_s, logits = [], []
    real_prefill = model.prefill

    def timed_prefill(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_prefill(*args, **kw)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        logits.append(out[0])
        return out

    model.prefill = timed_prefill
    torch.cuda.synchronize()
    for counter in counters:
        counter.reset_launch_counts()
    with record() as seen:
        t0 = time.perf_counter()
        res = engine.generate(prompt, gen_len, enc_inputs=enc)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    launches = {k: n for counter in counters
                for k, n in counter.launch_counts.items()}
    model.prefill = real_prefill
    return {"model": model, "params": params, "engine": engine,
            "prompt": prompt, "frames": enc, "res": res, "seen": seen,
            "launches": launches, "prefill_logits": logits[0],
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
                w = kssd.ssd_scan_work(*case, ins[0].dtype)
                nbytes, ops = w.bytes, sum(w.flops.values())
                rate = BF16_OPS_PER_S if dtype == "bfloat16" \
                    else F32_OPS_PER_S
                b_ms, b_by = work_ms(w)
                d_bytes = nbytes + kssd.ssd_design_bytes(*case)
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
            w = krg.rglru_scan_work(*case)
            b_ms, b_by = work_ms(w)
            t = {"shape": list(case), "bytes": w.bytes,
                 "ops": sum(w.flops.values()),
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


@contextlib.contextmanager
def recording_routes(layers):
    """Record the expert set (sorted, on the card) each MoE layer call of
    ``repro_torch.models.layers`` picks, in call order."""
    real, seen = layers._route, []

    def route(p, xt, k):
        out = real(p, xt, k)
        seen.append(out[2].sort(-1).values)
        return out

    layers._route = route
    try:
        yield seen
    finally:
        layers._route = real


def route_flips(torch, cfg, ours, plain, batch, seq):
    """Compare two runs' recorded expert sets call by call: the (token,
    layer) pairs that picked another set in full-sequence calls (a forward
    or a prefill, in MoE groups) and in decode steps, and the sequences a
    flip reaches: a whole group's (capacity couples its tokens) or a
    decoded sequence's."""
    check(len(ours) == len(plain) and all(
        a.shape == b.shape for a, b in zip(ours, plain)),
          f"{cfg.name}: the two runs made other MoE calls")
    t = batch * seq
    grouped = t > cfg.moe_group and t % cfg.moe_group == 0
    rows = cfg.moe_group if grouped else t
    groups, full_calls = t // rows, 0
    out = {"sequence_pairs": 0, "decode_pairs": 0}
    flipped = set()
    for a, b in zip(ours, plain):
        hit = (a != b).any(-1).nonzero().flatten().tolist()
        if a.shape[0] == rows and rows != batch:
            g = full_calls % groups
            full_calls += 1
            out["sequence_pairs"] += len(hit)
            if hit:
                flipped |= set(range(g * rows // seq,
                                     ((g + 1) * rows - 1) // seq + 1))
        else:
            out["decode_pairs"] += len(hit)
            flipped |= set(hit)
    out["flipped_sequences"] = sorted(flipped)
    return out


def _held(n, flips):
    return [i for i in range(n) if i not in set(flips["flipped_sequences"])]


def _sequence_ce(torch, logits, targets):
    """Each sequence's mean token CE, from (B, S, V) logits, a row at a
    time (the full float32 log-softmax of a 256k vocabulary is 8 GB)."""
    return torch.stack([
        -torch.log_softmax(lg.float(), -1).gather(
            -1, tg.long()[:, None])[:, 0].mean()
        for lg, tg in zip(logits, targets)])


def _moe_encdec_serve(torch, kern, kattn, ref, layers, label, cfg, batch,
                      prompt_len, gen_len, frames, out):
    """One model served on the card with the kernels and then with the
    plain versions; checks as the phase says.  Returns the model, params
    and its generator-drawn prompt for the loss runs."""
    want = _layer_launches(cfg)["flash_attention"]
    torch.cuda.reset_peak_memory_stats()
    run = serve(torch, (kattn,), cfg, batch, prompt_len, gen_len,
                frames=frames, record=lambda: recording_routes(layers))
    res, eng, prompt, enc = run["res"], run["engine"], run["prompt"], \
        run["frames"]
    n = run["launches"]["flash_attention"]
    tp = {"prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
          "prefill_tok_per_s": batch * prompt_len / run["prefill_s"],
          "decode_tok_per_s": batch * (gen_len - 1) / run["decode_s"],
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label} serve: batch {batch}, prompt {prompt_len}, {gen_len} "
          f"tokens: prefill {tp['prefill_s']:.4f} s "
          f"({tp['prefill_tok_per_s']:.1f} tok/s), decode "
          f"{tp['decode_s']:.4f} s ({tp['decode_tok_per_s']:.1f} tok/s), "
          f"peak {tp['peak_gb']:.3f} GB, flash_attention launches {n}",
          flush=True)
    check(n == want, f"{label} serve: flash_attention launched {n} times "
          f"in one prefill of {want} attention layers")
    import numpy as np
    check(np.isfinite(res.logprobs).all(),
          f"{label} serve: a log-probability is not finite")
    model, params = run["model"], run["params"]
    real_prefill, plain_logits = model.prefill, []

    def keep_logits(*args, **kw):
        got = real_prefill(*args, **kw)
        plain_logits.append(got[0])
        return got

    model.prefill = keep_logits
    with plain_versions(kern, ref, kattn), recording_routes(layers) as seen:
        kattn.reset_launch_counts()
        plain = eng.generate(prompt, gen_len, enc_inputs=enc)
        check(kattn.launch_counts["flash_attention"] == 0,
              f"{label}: the plain-version run launched the kernel")
    model.prefill = real_prefill
    flips = route_flips(torch, cfg, run["seen"], seen, batch, prompt_len)
    held = _held(batch, flips)
    logits_k, logits_p = run["prefill_logits"], plain_logits[0]
    check(bool(torch.isfinite(logits_k).all()),
          f"{label} serve: prefill logits are not finite")
    same = (res.tokens == plain.tokens).all(-1)
    # over every sequence, flipped ones included (recorded, not held)
    rec = {**tp, "launches": n, "router_flips": flips,
           "sequences_equal": int(same.sum()),
           "prefill_logits_max_abs_diff_all": float(
               (logits_k.float() - logits_p.float()).abs().max())}
    if held:
        scale = float(logits_p[held].float().abs().max())
        diff = float((logits_k[held].float()
                      - logits_p[held].float()).abs().max())
        rec.update(prefill_logits_max_abs_diff=diff, max_abs_logit=scale)
    print(f"{label} serve: router flips {flips}; prefill logits max "
          f"|kernel - plain| {rec['prefill_logits_max_abs_diff_all']!r} over "
          f"all sequences; {int(same.sum())} of "
          f"{batch} sequences' tokens equal to the plain versions'; held "
          f"{len(held)} of {batch} (left out {batch - len(held)}): prefill "
          f"logits max |kernel - plain| "
          f"{rec.get('prefill_logits_max_abs_diff')!r} of max |logit| "
          f"{rec.get('max_abs_logit')!r}", flush=True)
    if cfg.dtype == "float32":
        check(held, f"{label} serve: every sequence flipped a route")
        check(rec["prefill_logits_max_abs_diff"]
              <= PREFILL_RTOL * rec["max_abs_logit"],
              f"{label} serve: prefill logits differ by "
              f"{rec['prefill_logits_max_abs_diff']} > {PREFILL_RTOL} * "
              f"{rec['max_abs_logit']}")
        check(bool(same[held].all()),
              f"{label} serve: generated tokens differ from the plain "
              f"versions' in a sequence without a route flip")
    out["serve"][label] = rec
    out["launches"][f"{label} serve"] = n
    del run, res, eng, plain, logits_k, logits_p, plain_logits
    return model, params


def _moe_encdec_loss(torch, kern, kattn, ref, layers, label, model, params,
                     batch, seq, frames, out):
    """``loss`` on batch x seq tokens on the card: the median of LOSS_REPS
    calls after a warm-up, launches counted in the first; against the plain
    versions (float32: logits and each sequence's CE on the sequences
    without a route flip; bf16: CE).  Returns the batch and the kernels'
    CE (the gather path's yardstick)."""
    from repro_torch.models.frontends import synth_audio_frames
    cfg = model.cfg
    want = _layer_launches(cfg)["flash_attention"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device="cuda")
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if frames:
        b["enc_inputs"] = synth_audio_frames(gen, cfg, batch, frames)
    fwd_args = (b["tokens"],) + ((b["enc_inputs"],) if frames else ())
    with torch.inference_mode():
        model.loss(params, b)                        # warm-up, full shape
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kattn.reset_launch_counts()
        runs = []
        for rep in range(LOSS_REPS):
            t0 = time.perf_counter()
            loss_k, info_k = model.loss(params, b)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            if rep == 0:
                n = kattn.launch_counts["flash_attention"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        with recording_routes(layers) as seen_k:
            logits_k = model.forward(params, *fwd_args)[0]
        with plain_versions(kern, ref, kattn):
            kattn.reset_launch_counts()
            loss_p, info_p = model.loss(params, b)
            with recording_routes(layers) as seen_p:
                logits_p = model.forward(params, *fwd_args)[0]
            check(kattn.launch_counts["flash_attention"] == 0,
                  f"{label}: the plain-version run launched the kernel")
        flips = route_flips(torch, cfg, seen_k, seen_p, batch, seq)
        held = _held(batch, flips)
        ce_k = _sequence_ce(torch, logits_k, b["targets"])
        ce_p = _sequence_ce(torch, logits_p, b["targets"])
    secs = statistics.median(runs)
    rec = {"seconds": secs, "runs_s": runs, "tok_per_s": batch * seq / secs,
           "peak_gb": peak, "launches": n, "ce": float(info_k["ce"]),
           "ce_plain": float(info_p["ce"]), "router_flips": flips,
           "held_sequences": len(held),
           "logits_max_abs_diff_all": max(
               float((k.float() - p.float()).abs().max())
               for k, p in zip(logits_k, logits_p))}
    if "moe_aux" in info_k:
        rec["moe_aux"] = float(info_k["moe_aux"])
    if held:
        # row by row: seamless-m4t-large-v2's logits take 8.4 GB
        scale = max(float(logits_p[i].float().abs().max()) for i in held)
        diff = max(float((logits_k[i].float() - logits_p[i].float()).abs()
                         .max()) for i in held)
        rec.update(logits_max_abs_diff=diff, max_abs_logit=scale,
                   held_ce=float(ce_k[held].mean()),
                   held_ce_plain=float(ce_p[held].mean()))
    print(f"{label} loss: {batch} x {seq} tokens in {secs:.4f} s (median "
          f"of {runs}; {rec['tok_per_s']:.1f} tok/s), peak {peak:.3f} GB, "
          f"flash_attention launches {n}, CE kernels {rec['ce']!r} plain "
          f"{rec['ce_plain']!r}, logits max |diff| over all "
          f"{rec['logits_max_abs_diff_all']!r}, router flips {flips}, held "
          f"{len(held)} of {batch}: logits max |diff| {rec.get('logits_max_abs_diff')!r} "
          f"of {rec.get('max_abs_logit')!r}, CE {rec.get('held_ce')!r} vs "
          f"{rec.get('held_ce_plain')!r}", flush=True)
    check(n == want, f"{label} loss: flash_attention launched {n} times, "
          f"want {want}")
    check(math.isfinite(rec["ce"]) and math.isfinite(rec["ce_plain"]),
          f"{label} loss: CE is not finite")
    if cfg.dtype == "float32":
        check(held, f"{label} loss: every sequence flipped a route")
        check(rec["logits_max_abs_diff"]
              <= PREFILL_RTOL * rec["max_abs_logit"],
              f"{label} loss: logits differ by {rec['logits_max_abs_diff']}"
              f" > {PREFILL_RTOL} * {rec['max_abs_logit']}")
        check(abs(rec["held_ce"] - rec["held_ce_plain"])
              <= CE_RTOL * abs(rec["held_ce_plain"]),
              f"{label} loss: CE {rec['held_ce']} vs {rec['held_ce_plain']}"
              f" (relative {CE_RTOL})")
    else:
        check(abs(rec["ce"] - rec["ce_plain"]) <= CE_ATOL_BF16,
              f"{label} loss: CE {rec['ce']} vs {rec['ce_plain']} (within "
              f"{CE_ATOL_BF16})")
    out["loss"][label] = rec
    out["launches"][f"{label} loss"] = n
    del logits_k, logits_p
    return b, float(loss_k)


def moe_encdec_phase(torch, kern, kattn, ref):
    """The MoE and encoder-decoder families at full width on the card, with
    use_kernels=True and random weights from seed 0: (a) olmoe-1b-7b served
    and scored in float32 and bfloat16, and its loss through
    moe_dispatch="gather" once in float32; (b) mixtral-8x22b cut to
    MIXTRAL_LAYERS layers, served in float32; (c) seamless-m4t-large-v2
    served and scored in float32 and bfloat16, with stub audio frames.
    Returns the launches of each run, the throughputs and the flips."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import layers
    t_phase = time.perf_counter()
    out = {"launches": {}, "serve": {}, "loss": {}}
    for arch, dtypes in (("olmoe-1b-7b", ("float32", "bfloat16")),
                         ("mixtral-8x22b", ("float32",)),
                         ("seamless-m4t-large-v2", ("float32", "bfloat16"))):
        base = dataclasses.replace(get_config(arch), use_kernels=True)
        batch, prompt_len, gen_len = MOE_BATCH, MOE_PROMPT, MOE_GEN
        if arch == "mixtral-8x22b":
            base = dataclasses.replace(base, num_layers=MIXTRAL_LAYERS)
            batch, prompt_len, gen_len = 1, MIXTRAL_PROMPT, MIXTRAL_GEN
        frames = prompt_len // base.encoder_frames_ratio \
            if base.family == "encdec" else 0
        for dtype in dtypes:
            label = f"{arch} {dtype}"
            cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
            model, params = _moe_encdec_serve(
                torch, kern, kattn, ref, layers, label, cfg, batch,
                prompt_len, gen_len, frames, out)
            if arch != "mixtral-8x22b":
                b, loss_einsum = _moe_encdec_loss(
                    torch, kern, kattn, ref, layers, label, model, params,
                    MOE_BATCH, MOE_PROMPT, frames, out)
                if cfg.num_experts and dtype == "float32":
                    gather = build_model(dataclasses.replace(
                        cfg, moe_dispatch="gather"))
                    with torch.inference_mode():
                        loss_g = float(gather.loss(params, b)[0])
                    gap = abs(loss_g - loss_einsum) / abs(loss_einsum)
                    out["gather"] = {"loss": loss_g, "einsum": loss_einsum,
                                     "relative_gap": gap}
                    print(f"{label} loss through moe_dispatch='gather': "
                          f"{loss_g!r}, einsum {loss_einsum!r}, relative "
                          f"gap {gap!r}", flush=True)
                    check(gap <= GATHER_RTOL,
                          f"{label}: the gather path's loss is {gap} "
                          f"relative from the einsum path's")
                del b
            del model, params
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"moe_encdec phase: {out['seconds']:.1f} s (budget "
          f"{MOE_ENCDEC_BUDGET_S} s)", flush=True)
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


def examples_phase(torch, kern, kattn, ref):
    """The twins of the JAX package's ``examples/``
    (``repro_torch.examples``) on the card through their ``main``s, one
    JSON line each with its setting, device, wall seconds and result.
    quickstart, multilevel_hsgd and population_hsgd also on the CPU: the
    final loss and accuracy, each run's final loss and each round's train
    loss within LOSS_RTOL relative, population's clients seen equal; no
    kernel may launch (no codec on their path).  serve_decode per arch
    with the kernels, then with the plain versions on the card: greedy
    tokens equal, and one ``flash_attention`` launch per causal
    self-attention layer in the prefill (none in decode, the SSM scans
    not in a prefill).  train_hsgd into fresh ``--ckpt-dir`` and
    ``--out`` under EXAMPLES_DIR: ``int8_scale_quantize`` launched once
    per wire sync and int8 bucket, the checkpoints of steps 60 and 120
    written, every step record carrying ``sim_time_s``.  Returns the
    phase's record with the launches by run."""
    import io
    import shutil
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import two_level
    from repro_torch.examples import (multilevel_hsgd, population_hsgd,
                                      quickstart, serve_decode, train_hsgd)
    t_phase = time.perf_counter()
    rec = {"twins": [], "launches": {"flash_attention": {},
                                     "int8_scale_quantize": {}}}

    def reset():
        kern.reset_launch_counts()
        kattn.reset_launch_counts()

    def launched():
        return {k: n for mod in (kern, kattn)
                for k, n in mod.launch_counts.items() if n}

    def run(name, setting, device, fn, quiet=False):
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out) if quiet \
                else contextlib.nullcontext():
            result = fn()
        torch.cuda.synchronize()
        line = {"example": name, "setting": setting, "device": device,
                "wall_s": time.perf_counter() - t0, "result": result}
        print(json.dumps(line), flush=True)
        rec["twins"].append(line)
        return result, out.getvalue()

    def rel(a, b):
        return abs(a - b) / abs(b)

    # the MLP twins, card against CPU
    for name, mod, keys in (("quickstart", quickstart, ("loss", "acc")),
                            ("multilevel_hsgd", multilevel_hsgd,
                             ("loss",)),
                            ("population_hsgd", population_hsgd, ("ce",))):
        reset()
        card, _ = run(name, "the example's", "cuda",
                      lambda: mod.main("cuda"))
        check(not launched(), f"{name} launched kernels: {launched()}")
        cpu, _ = run(name, "the example's", "cpu", lambda: mod.main("cpu"),
                     quiet=True)
        check(len(card) == len(cpu), f"{name}: {len(card)} records on the "
              f"card, {len(cpu)} on the CPU")
        worst = max(rel(c[k], h[k]) for c, h in zip(card, cpu) for k in keys)
        final = max(rel(card[-1][k], cpu[-1][k]) for k in keys)
        print(f"{name}: card vs CPU, largest relative difference {worst!r} "
              f"(final record {final!r})", flush=True)
        rec[name] = {"rel_max": worst, "rel_final": final}
        check(all(math.isfinite(c[k]) for c in card for k in keys)
              and (final if name == "quickstart" else worst) <= LOSS_RTOL,
              f"{name}: card vs CPU differ by {worst} relative (final "
              f"{final}) > {LOSS_RTOL}")
        if name == "population_hsgd":
            check([(c["t"], c["unique"]) for c in card]
                  == [(h["t"], h["unique"]) for h in cpu],
                  "population_hsgd: other steps or clients seen on the card "
                  "than on the CPU")

    # serve_decode per arch: the kernels against the plain versions
    rec["serve_decode"] = {}
    for arch in serve_decode.ARCHS:
        cfg = reduced(get_config(arch))
        reset()
        ours, _ = run("serve_decode", f"{arch}, kernels", "cuda",
                      lambda: serve_decode.main("cuda", archs=(arch,)))
        counts = dict(kattn.launch_counts)
        with plain_versions(kern, ref, kattn):
            plain, _ = run("serve_decode", f"{arch}, plain versions",
                           "cuda", lambda: serve_decode.main(
                               "cuda", archs=(arch,)))
        check(dict(kattn.launch_counts) == counts,
              f"serve_decode {arch}: the plain versions' run launched a "
              "kernel")
        want = _layer_launches(cfg)["flash_attention"]
        check(counts["flash_attention"] == want,
              f"serve_decode {arch}: {counts['flash_attention']} "
              f"flash_attention launches, predicted {want}")
        if want:
            rec["launches"]["flash_attention"][
                f"examples serve_decode {arch} float32"] = want
        check(ours[arch] == plain[arch],
              f"serve_decode {arch}: greedy tokens with the kernels "
              f"{ours[arch]} differ from the plain versions' {plain[arch]}")
        rec["serve_decode"][arch] = {
            "tokens": ours[arch], "flash_attention": counts["flash_attention"]}
        print(f"serve_decode {arch}: greedy tokens equal to the plain "
              f"versions' on the card, {counts['flash_attention']} "
              f"flash_attention launches", flush=True)

    # train_hsgd into fresh paths
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    ckpt, out = EXAMPLES_DIR / "ckpt", EXAMPLES_DIR / "history.json"
    try:
        reset()
        history, printed = run(
            "train_hsgd", f"the example's argv, --ckpt-dir {ckpt} --out "
            f"{out}", "cuda", lambda: train_hsgd.main(
                "cuda", {"--ckpt-dir": str(ckpt), "--out": str(out)}),
            quiet=True)
        counts = dict(kern.launch_counts)
        lines = [json.loads(x) for x in printed.splitlines()
                 if x.startswith("{")]
        wire = next(x["wire"] for x in lines if "wire" in x)
        buckets = sum(p["dtype"] == "int8" for p in wire["payload"])
        argv = train_hsgd.argv()
        flag = lambda name: int(argv[argv.index(name) + 1])  # noqa: E731
        syncs = _train_syncs(two_level(flag("--workers"), flag("--groups"),
                                       flag("--G"), flag("--I")),
                             0, flag("--steps"))
        check(counts["int8_scale_quantize"] == syncs * buckets,
              f"train_hsgd: {counts['int8_scale_quantize']} "
              f"int8_scale_quantize launches, predicted {syncs} syncs x "
              f"{buckets} int8 buckets")
        rec["launches"]["int8_scale_quantize"][
            "examples train_hsgd"] = counts["int8_scale_quantize"]
        files = sorted(p.name for p in ckpt.iterdir())
        check(files == ["ckpt_00000060.msgpack", "ckpt_00000120.msgpack"],
              f"train_hsgd: checkpoints {files}")
        steps_rec = [x for x in lines if "step" in x]
        check(len(steps_rec) == len(history) and steps_rec
              and all(math.isfinite(x["sim_time_s"])
                      and math.isfinite(x["loss"]) for x in steps_rec),
              "train_hsgd: a step record without sim_time_s or with a "
              "loss not finite")
        check(json.loads(out.read_text()) == json.loads(
            json.dumps(history)), "train_hsgd: --out differs from the "
            "returned history")
        rec["train_hsgd"] = {
            "syncs": syncs, "int8_buckets": buckets,
            "int8_scale_quantize": counts["int8_scale_quantize"],
            "checkpoints": files, "records": len(steps_rec),
            "final": steps_rec[-1]}
        print(f"train_hsgd: {len(steps_rec)} records, "
              f"{counts['int8_scale_quantize']} int8_scale_quantize launches"
              f" = {syncs} syncs x {buckets} buckets, checkpoints {files}, "
              f"final {steps_rec[-1]}", flush=True)
    finally:
        shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    rec["wall_s"] = time.perf_counter() - t_phase
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
          f"Metrics.op_budget('sim') = {on['op_budget_sim']} (counts "
          f"reduces, not launches: the audit enforces it in the analysis "
          f"phase); "
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
    twin = bench_obs.run(quick=True, device="cuda", backends=("sim",))
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


def _pop_engine(device, comms=None, cells=POP_CELLS, executor=None, **pop):
    """bench_population's world under the population regime, on the sim
    or ``executor``; returns the engine, its server state (from
    ``torch.Generator().manual_seed(0)``), the batch function and the
    server's loss on a fixed eval batch."""
    import numpy as np
    import torch
    from repro_torch.core import EngineConfig, HSGD
    from repro_torch.experiments import bench_population as bp
    from repro_torch.population import Population
    from repro_torch.optim import sgd
    model, shards = bp.make_world()
    eng = HSGD(model.loss, sgd(bp.LR), bp._topology(), EngineConfig(
        comms=comms, executor=executor,
        population=Population(cells=cells, seed=bp.SEED, **pop)))
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


def _train(argv, device: str):
    """``repro_torch.launch.train.main(argv, device)`` with its standard
    output captured: (history, {"header", "wire", "runtime", "other"})."""
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        history = train.main(list(argv), device=device)
    lines = {"other": []}
    for line in buf.getvalue().splitlines():
        rec = json.loads(line) if line.startswith("{") else None
        if rec is None:
            lines["other"].append(line)
        elif "schema_version" in rec:
            lines["header"] = rec
        elif "wire" in rec:
            lines["wire"] = rec["wire"]
        elif "runtime" in rec:
            lines["runtime"] = rec
        elif "step" not in rec:
            lines["other"].append(rec)
    return history, lines


def _train_syncs(spec, t0: int, t1: int) -> int:
    """Sync events of the hierarchy ``spec`` in steps t0..t1-1."""
    return sum(spec.sync_level(t) is not None for t in range(t0, t1))


@contextlib.contextmanager
def _deterministic(torch, label: str):
    """``torch.use_deterministic_algorithms`` for the block; fails naming
    every op that warned it has no deterministic CUDA version."""
    import warnings
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
    nondet = sorted({str(w.message).splitlines()[0] for w in caught
                     if "deterministic" in str(w.message)})
    check(not nondet, f"{label}: ops without a deterministic CUDA version: "
          f"{nondet}")


def _same_file(a: Path, b: Path) -> bool:
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 26), fb.read(1 << 26)
            if x != y:
                return False
            if not x:
                return True


def _ckpt_gap(a: Path, b: Path) -> float:
    """Largest |difference| between two small checkpoints' leaves."""
    import torch
    from repro_torch.checkpoint import _msgpack

    def leaves(path):
        with open(path, "rb") as f:
            payload = _msgpack.read(f)["payload"]
        for r in payload:
            bf16 = r["dtype"] == "bfloat16"
            x = torch.frombuffer(r["data"], dtype=torch.int16 if bf16
                                 else getattr(torch, r["wire"])) \
                if len(r["data"]) else torch.zeros(0)
            yield (x.view(torch.bfloat16) if bf16 else x).double()
    xs, ys = list(leaves(a)), list(leaves(b))
    check(len(xs) == len(ys) and all(x.shape == y.shape
                                     for x, y in zip(xs, ys)),
          f"{a} and {b} hold different trees")
    return max((float((x - y).abs().max()) for x, y in zip(xs, ys)
                if x.numel()), default=0.0)


def train_mesh_rank(rank: int, argv):
    """One rank of the train phase's mesh run: launch.train in this rank,
    its kernel launches counted; rank 0 returns its history and every
    rank's counts."""
    import io
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import comms as kern
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        history = train.main(list(argv), device="cuda")
    counts = dict(kern.launch_counts)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, counts)
    return {"history": history, "launches": everyone}


def train_long_leg(torch):
    """(e) of the train phase (see TRAIN_LONG): its record."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves
    args = train.build_argparser().parse_args(TRAIN_ARGV + TRAIN_LONG)
    spec = train.make_spec(args)
    cfg = get_config(args.arch)
    stream = train.make_stream(args, cfg.vocab_size, spec.n_workers, "cuda")
    batches = [stream(t) for t in range(TRAIN_LONG_STEPS)]
    out = {"allocated_before_gb": torch.cuda.memory_allocated() / 1e9}
    print(f"train (e): {out['allocated_before_gb']:.3f} GB allocated "
          "before the leg", flush=True)

    def fresh():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    for remat in (False, True):
        label = f"remat {'on' if remat else 'off'}"
        model = build_model(dataclasses.replace(cfg, remat=remat))
        eng = train.make_engine(args, model, spec)
        state = eng.init_from_params(train.init_params(model, args.seed,
                                                       "cuda"),
                                     device="cuda")
        step = eng.step_fn(None)
        fresh()
        times, ces = [], []
        with _deterministic(torch, f"train (e) {label}"):
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                ces.append(metrics["ce"].tolist())
        peak = torch.cuda.max_memory_allocated() / 1e9
        lo, hi = TRAIN_LONG_PEAK_GB[label]
        out[label] = {"peak_gb": peak, "predicted_peak_gb": [lo, hi],
                      "step_s": times, "steps_per_s": 1.0 / times[-1],
                      "tokens_per_s": spec.n_workers * args.batch
                      * args.seq / times[-1], "ce": ces}
        print(f"train (e) qwen2-0.5b bfloat16, {spec.n_workers} x "
              f"{args.batch} x {args.seq} tokens, {label}: peak {peak:.3f} "
              f"GB (predicted {lo}-{hi}), step s {times}, "
              f"{out[label]['steps_per_s']:.4f} steps/s, ce {ces}",
              flush=True)
        del state, eng, step, model, metrics
        fresh()
    off, on = out["remat off"]["ce"], out["remat on"]["ce"]
    check(off[0] == on[0], f"train (e): remat changes the first step's CE: "
          f"{off[0]} against {on[0]}")

    # the gradient, in float32, of one worker's loss at the same params
    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = train.init_params(build_model(f32), args.seed, "cuda")
    one = {k: v[0] for k, v in batches[0].items()}
    grads = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(f32, remat=remat))
        fresh()
        g = torch.func.grad(lambda p: model.loss(p, one)[0])(params)
        torch.cuda.synchronize()
        grads[remat] = tree_leaves(g)
        out[f"float32 grad peak_gb remat {'on' if remat else 'off'}"] = \
            torch.cuda.max_memory_allocated() / 1e9
        del g
    top = max(float(t.abs().max()) for t in grads[False])
    gap = max(float((a - b).abs().max())
              for a, b in zip(grads[True], grads[False]))
    same = all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    out["grad_max_abs_diff"], out["grad_bitwise"] = gap, same
    out["grad_largest"] = top
    print(f"train (e): float32 gradient of one worker's loss, remat on "
          f"against off: max |diff| {gap!r} of the largest {top!r} "
          f"({gap / top!r}), bit for bit {same}; peaks "
          f"{out['float32 grad peak_gb remat off']:.3f} / "
          f"{out['float32 grad peak_gb remat on']:.3f} GB", flush=True)
    check(gap <= REMAT_RTOL * top, f"train (e): remat moves the gradient by "
          f"{gap} > {REMAT_RTOL} x {top}")
    del grads, params
    fresh()
    return out


def train_phase(torch, kern, ref):
    """H-SGD training of the LMs through ``repro_torch.launch.train`` on
    the card, (a) to (d) as set out at TRAIN_ARGV.  Returns the record."""
    import gc
    import shutil
    from repro_torch.launch import train
    from repro_torch.launch.mesh import launch
    t_phase = time.perf_counter()
    root = ROOT / "build" / "train_phase"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rec = {"card": card_line()}
    args = train.build_argparser().parse_args(TRAIN_ARGV)
    spec = train.make_spec(args)
    tokens = spec.n_workers * args.batch * args.seq   # a step, all workers
    marks, timing = [], {"save_s": [], "restore_s": []}
    orig = {k: getattr(train, k) for k in ("save", "restore", "make_stream")}

    def timed_save(path, step, tree):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig["save"](path, step, tree)
        timing["save_s"].append(time.perf_counter() - t0)
        return out

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = orig["restore"](*a, **kw)
        torch.cuda.synchronize()
        timing["restore_s"].append(time.perf_counter() - t0)
        return out

    def marked_stream(args_, vocab, n, device):
        stream = orig["make_stream"](args_, vocab, n, device)

        def batch(t):
            # the timed window opens at the second round's batch: the
            # first round (I steps) is out; no other batch waits
            if not marks or t == marks[0][0] + args.I:
                torch.cuda.synchronize()
                marks.append((t, time.perf_counter()))
            return stream(t)
        return batch

    def full(label, extra=(), plain=False):
        kern.reset_launch_counts()
        marks.clear()
        timing["save_s"].clear()
        timing["restore_s"].clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with plain_versions(kern, ref) if plain else contextlib.nullcontext():
            hist, lines = _train(list(TRAIN_ARGV) + list(extra), "cuda")
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        # steps/s: first round and checkpoint writes excluded
        (first, _), (_, t_from) = marks
        steps = hist[-1]["step"] - first - args.I
        sps = steps / (t_end - t_from - sum(timing["save_s"]))
        run = {"history": hist, "lines": lines,
               "launches": dict(kern.launch_counts),
               "seconds": t_end - t0, "steps": steps, "steps_per_s": sps,
               "tok_per_s": sps * tokens,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "save_s": list(timing["save_s"]),
               "restore_s": list(timing["restore_s"])}
        losses = [r["loss"] for r in hist]
        print(f"train (a) {label}: losses {losses}, {run['seconds']:.1f} s, "
              f"{sps!r} steps/s, {run['tok_per_s']!r} tok/s over {steps} "
              f"steps (first round and checkpoint writes excluded), peak "
              f"{run['peak_gb']:.3f} GB, checkpoint writes "
              f"{run['save_s']} s, reads {run['restore_s']} s, launches "
              f"{run['launches']}", flush=True)
        check(all(math.isfinite(x) for x in losses),
              f"train (a) {label}: a loss is not finite: {losses}")
        return run

    for k, fn in (("save", timed_save), ("restore", timed_restore),
                  ("make_stream", marked_stream)):
        setattr(train, k, fn)
    try:
        # (a) full width, deterministic algorithms for this part only
        a_dir, b_dir, c_dir = root / "a", root / "b", root / "c"
        ckpt = lambda d: ("--ckpt-dir", str(d),
                          "--ckpt-every", str(TRAIN_CKPT_EVERY))
        with _deterministic(torch, "train (a)"):
            kernel = full("kernels", ckpt(a_dir))
            plain = full("plain versions", ckpt(b_dir), plain=True)
            (b_dir / "ckpt_00000004.msgpack").unlink()
            c_dir.mkdir()
            os.replace(a_dir / "ckpt_00000004.msgpack",
                       c_dir / "ckpt_00000004.msgpack")
            resumed = full("resumed from step 4", ckpt(c_dir))
        a8 = a_dir / "ckpt_00000008.msgpack"
        ckpt_bytes = a8.stat().st_size
        payload = kernel["lines"]["wire"]["payload"]
        buckets = sum(a["name"].endswith(".q") for a in payload)
        predicted = {
            "kernels": _train_syncs(spec, 0, args.steps) * buckets,
            "resumed from step 4":
                _train_syncs(spec, TRAIN_CKPT_EVERY, args.steps) * buckets}
        for label, run in (("kernels", kernel),
                           ("resumed from step 4", resumed)):
            got = run["launches"]["int8_scale_quantize"]
            check(got == predicted[label],
                  f"train (a) {label}: {got} int8_scale_quantize launches, "
                  f"predicted {predicted[label]} (one per sync and int8 "
                  f"bucket, {buckets} bucket(s))")
        check(not any(plain["launches"].values()),
              f"train (a): the plain versions' run launched "
              f"{plain['launches']}")
        check(f"resumed from step {TRAIN_CKPT_EVERY}"
              in resumed["lines"]["other"],
              "train (a): the resumed run did not resume from step 4")
        check(resumed["history"][0]["step"] == TRAIN_CKPT_EVERY + 1,
              f"train (a): the resumed run's first record is "
              f"{resumed['history'][0]}")
        same_plain = _same_file(a8, b_dir / "ckpt_00000008.msgpack")
        same_resume = _same_file(a8, c_dir / "ckpt_00000008.msgpack")
        loss_plain = [r["loss"] for r in plain["history"]]
        loss_kernel = [r["loss"] for r in kernel["history"]]
        loss_resume = [r["loss"] for r in resumed["history"]]
        check(same_plain and loss_plain == loss_kernel,
              "train (a): the kernels' run differs from the plain "
              "versions' run (step-8 checkpoint or losses)")
        check(same_resume and loss_resume == loss_kernel[TRAIN_CKPT_EVERY:],
              "train (a): the run resumed from step 4 differs from "
              "the uninterrupted run (step-8 checkpoint or losses)")
        save_s = kernel["save_s"] + plain["save_s"] + resumed["save_s"]
        rec["full"] = {
            "argv": list(TRAIN_ARGV), "params": TRAIN_PARAMS,
            "losses": loss_kernel,
            "deterministic_steps_per_s": kernel["steps_per_s"],
            "plain_steps_per_s": plain["steps_per_s"],
            "peak_gb": kernel["peak_gb"], "plain_peak_gb": plain["peak_gb"],
            "resumed_peak_gb": resumed["peak_gb"],
            "ckpt_gb": ckpt_bytes / 1e9, "save_s": save_s,
            "write_gb_per_s": [ckpt_bytes / 1e9 / t for t in save_s],
            "restore_s": resumed["restore_s"],
            "read_gb_per_s": [ckpt_bytes / 1e9 / t
                              for t in resumed["restore_s"]],
            "launches": {"kernels": kernel["launches"],
                         "resumed": resumed["launches"]},
            "predicted_int8_launches": predicted,
            "wire_payloads_per_sync": {
                lvl: v["payloads_per_sync"] for lvl, v in
                kernel["lines"]["wire"]["per_level"].items()},
            "bitwise_plain": same_plain, "bitwise_resume": same_resume,
            "seconds": kernel["seconds"] + plain["seconds"]
            + resumed["seconds"]}
        print(f"train (a): qwen2-0.5b full width, {TRAIN_PARAMS} params, "
              f"checkpoint {ckpt_bytes / 1e9:.3f} GB, write "
              f"{[round(x, 3) for x in rec['full']['write_gb_per_s']]} GB/s, "
              f"read {[round(x, 3) for x in rec['full']['read_gb_per_s']]} "
              f"GB/s; kernels vs plain versions bit for bit {same_plain}, "
              f"resume bit for bit {same_resume}; int8_scale_quantize "
              f"launches {predicted} as predicted; {card_line()}",
              flush=True)
        shutil.rmtree(a_dir)
        shutil.rmtree(b_dir)
        shutil.rmtree(c_dir)
        del kernel, plain, resumed
        # the speed: default (nondeterministic) algorithms, no checkpoints,
        # a longer window
        fast = full("kernels, default algorithms, no checkpoints",
                    ("--steps", str(TRAIN_SPEED_STEPS)))
        rec["full"].update({
            "steps_per_s": fast["steps_per_s"],
            "tok_per_s": fast["tok_per_s"], "speed_steps": fast["steps"],
            "speed_peak_gb": fast["peak_gb"]})
        del fast
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for k, fn in orig.items():
            setattr(train, k, fn)

    # (b) reduced, card against CPU; the card's runs under deterministic
    # algorithms, so that sign's kernels and plain versions agree bit for
    # bit
    rec["reduced"], rec["launches"] = {}, {"int8_scale_quantize": {
        "train full width (kernels)": rec["full"]["launches"]["kernels"][
            "int8_scale_quantize"],
        "train full width (resumed)": rec["full"]["launches"]["resumed"][
            "int8_scale_quantize"]}, "sign_pack": {}}
    step8 = f"ckpt_{args.steps:08d}.msgpack"
    for label, extra in TRAIN_REDUCED:
        argv = list(TRAIN_ARGV) + ["--reduced"] + list(extra)
        # population mode takes no --ckpt-dir
        dirs = {} if label == "population" else {
            d: root / f"{label}_{d}" for d in ("card", "host", "plain")}

        def with_ckpt(d):
            return argv + ([] if not dirs else [
                "--ckpt-dir", str(dirs[d]), "--ckpt-every", str(args.steps)])
        kern.reset_launch_counts()
        t0 = time.perf_counter()
        with _deterministic(torch, f"train (b) {label}"):
            gpu, gpu_lines = _train(with_ckpt("card"), "cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(kern.launch_counts)
            if label == "sign":
                with plain_versions(kern, ref):
                    plain, _ = _train(with_ckpt("plain"), "cuda")
                check(dict(kern.launch_counts) == counts,
                      "train (b) sign: the plain versions' run launched a "
                      "kernel")
        cpu, cpu_lines = _train(with_ckpt("host"), "cpu")
        check([r["step"] for r in gpu] == [r["step"] for r in cpu],
              f"train (b) {label}: records of other steps on card and CPU")
        rel = max(abs(g["loss"] - c["loss"]) / abs(c["loss"])
                  for g, c in zip(gpu, cpu))
        for g, c in zip(gpu, cpu):
            for key in ("wire_cum_bytes", "wire_bytes", "sim_time_s",
                        "sim_sync_s", "dropped", "participation", "lvl"):
                check(g.get(key) == c.get(key),
                      f"train (b) {label}: {key} {g.get(key)} on the card, "
                      f"{c.get(key)} on the CPU at step {g['step']}")
            check(math.isfinite(g["loss"]),
                  f"train (b) {label}: loss not finite: {g}")
        # div_* against the largest of the record's divergences
        divs = [abs(g[k] - c[k]) / max(max(abs(c[j]) for j in c
                                           if j.startswith("div_")), 1e-30)
                for g, c in zip(gpu, cpu) for k in c if k.startswith("div_")]
        check(rel <= TRAIN_REDUCED_RTOL
              and all(d <= TRAIN_REDUCED_RTOL for d in divs),
              f"train (b) {label}: card vs CPU loss {rel} or div_* "
              f"{max(divs, default=0.0)} relative > {TRAIN_REDUCED_RTOL}")
        check(gpu_lines.get("wire") == cpu_lines.get("wire")
              and gpu_lines.get("runtime") == cpu_lines.get("runtime"),
              f"train (b) {label}: the wire or runtime line differs")
        gap = _ckpt_gap(dirs["card"] / step8, dirs["host"] / step8) \
            if dirs else None
        if dirs and label != "sign":
            check(gap <= TRAIN_REDUCED_ATOL,
                  f"train (b) {label}: card vs CPU step-{args.steps} params "
                  f"differ by {gap} > {TRAIN_REDUCED_ATOL}")
        bitwise = None
        if label == "sign":
            bitwise = ([r["loss"] for r in plain] == [r["loss"] for r in gpu]
                       and _same_file(dirs["card"] / step8,
                                      dirs["plain"] / step8))
            check(bitwise, "train (b) sign: the kernels' run on the card "
                  "differs from the plain versions' run there (losses or "
                  f"step-{args.steps} checkpoint)")
        codec = "sign_pack" if label == "sign" else "int8_scale_quantize"
        check(counts[codec] > 0,
              f"train (b) {label}: {codec} was never launched")
        if label == "sign":
            want = _train_syncs(spec, 0, args.steps)
            check(counts[codec] == want,
                  f"train (b) sign: {counts[codec]} sign_pack launches, "
                  f"predicted {want}")
        rec["launches"][codec][f"train reduced {label}"] = counts[codec]
        rec["reduced"][label] = {
            "loss_rel": rel, "div_rel": max(divs, default=None),
            "params_gap": gap, "bitwise_plain": bitwise,
            "losses": [r["loss"] for r in gpu], "seconds": secs,
            "launches": counts,
            "dropped": sum(r.get("dropped", 0) for r in gpu)}
        print(f"train (b) {label}: card vs CPU loss relative {rel!r}, div_* "
              f"{max(divs, default=None)!r}, step-{args.steps} params gap "
              f"{gap!r}, kernels vs plain versions on the card bit for bit "
              f"{bitwise}, wire/clock/drop fields equal, {secs:.2f} s on the "
              f"card, launches {counts}", flush=True)
    check(rec["reduced"]["runtime"]["dropped"] > 0,
          "train (b) runtime: the deadline dropped no worker")

    # (c) mesh: topk on TRAIN_MESH_WORKERS gloo ranks against the sim
    argv = list(TRAIN_ARGV) + ["--reduced", "--comms", "topk"]
    sim, _ = _train(argv, "cuda")
    t0 = time.perf_counter()
    res = launch(train_mesh_rank, TRAIN_MESH_WORKERS, backend="gloo",
                 device="cuda", args=(argv + ["--backend", "mesh"],),
                 timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    mesh = res["history"]
    per_rank = [c["topk_decode_reduce"] for c in res["launches"]]
    rel = max(abs(m["loss"] - s["loss"]) / abs(s["loss"])
              for m, s in zip(mesh, sim))
    print(f"train (c) mesh topk, {TRAIN_MESH_WORKERS} gloo ranks: launch "
          f"and run {wall:.1f} s, topk_decode_reduce per rank {per_rank}, "
          f"loss vs the sim relative {rel!r}", flush=True)
    want = _train_syncs(spec, 0, args.steps)
    check(per_rank == [want] * TRAIN_MESH_WORKERS,
          f"train (c): topk_decode_reduce launches per rank {per_rank}, "
          f"predicted {want} each")
    check([m["step"] for m in mesh] == [s["step"] for s in sim]
          and all(m["wire_cum_bytes"] == s["wire_cum_bytes"]
                  for m, s in zip(mesh, sim)) and rel <= MESH_ATOL,
          f"train (c): the mesh's records differ from the sim's (loss "
          f"relative {rel} > {MESH_ATOL}, or steps or wire bytes)")
    rec["mesh"] = {"wall_s": wall, "topk_per_rank": per_rank,
                   "loss_rel": rel}

    # (d) serving from a checkpoint written on the card
    from repro_torch.checkpoint import save
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import DecodeEngine
    model = build_model(get_config("qwen2-0.5b"))
    p1 = model.init(torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    save(str(root / "serve"), 0, {"params": p1})
    with contextlib.redirect_stdout(sys.stderr):
        res = serve.main(["--arch", "qwen2-0.5b", "--batch", "2",
                          "--prompt-len", "16", "--gen", "8", "--ckpt-dir",
                          str(root / "serve")], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.init(gen, device="cuda")
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=gen,
                           device="cuda")
    want = DecodeEngine(model, p1, device="cuda").generate(prompt, 8)
    same = torch.equal(torch.as_tensor(res.tokens).cpu(),
                       torch.as_tensor(want.tokens).cpu())
    print(f"train (d) serve --ckpt-dir: greedy tokens equal to the "
          f"in-memory params' {same}", flush=True)
    check(same, "train (d): serve --ckpt-dir gives other tokens than the "
          "same params in memory")
    shutil.rmtree(root)
    del model, p1, res, want
    gc.collect()
    torch.cuda.empty_cache()
    rec["long"] = train_long_leg(torch)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"train phase: {rec['wall_s']:.1f} s (budget {TRAIN_BUDGET_S} s)",
          flush=True)
    return rec


# analysis phase: the audit (repro_torch.analysis) on the card.  (a) the
# matrix's nine sim configs audited on the card with the kernels and on
# the CPU with their plain versions: the two reports equal field for
# field; each sync event's kernel regions equal the launch counters of
# one recorded sync; each distinct round body called once under
# torch.cuda.set_sync_debug_mode("warn") raises no synchronizing-call
# warning (R3's zero, cross-checked; a warning's sites are printed and
# fail the phase).  (b) the six mesh configs and bench_obs's static leg
# on both topologies in one launch of ANALYSIS_MESH_WORKERS gloo ranks on
# the card.  The fifteen card reports pass the budget's check
# (ANALYSIS_budget_torch.json, no waiver), as ``python -m
# repro_torch.analysis --check`` runs it; bench_obs's static leg on the
# sim on the card too.  (c) launch.train --audit at TRAIN_ARGV's full
# width, ANALYSIS_TRAIN_STEPS steps: each event's ops, payload and the
# WireStats bytes printed beside the prediction for one f32 bucket of
# TRAIN_PARAMS elements (1 op, 4 bytes an element, int8 plus one f32
# scale per 256), no finding.  (d) bench_comms's twin with --wall-clock on
# the card: its static asserts hold (a failure fails the phase); its two
# wall-clock bounds are printed and recorded, true or false, and never
# loosened.  The phase should take under ANALYSIS_BUDGET_S (printed)
ANALYSIS_MESH_WORKERS = 8
ANALYSIS_TRAIN_STEPS = 2
ANALYSIS_BUDGET_S = 90.0
ANALYSIS_INT8_BLOCK = 256


def analysis_mesh_rank(rank: int, configs, budget, device: str):
    """One rank of the analysis phase's launch: the mesh configs' audits
    and bench_obs's static leg on both topologies, launches counted from
    zero; rank 0 returns its reports, probes blocks and launches."""
    import torch
    from repro_torch.analysis.matrix import audit_config
    from repro_torch.experiments import bench_obs
    from repro_torch.kernels import comms as kern
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern.reset_launch_counts()
    reports = [audit_config(c, budget, device).to_dict() for c in configs]
    launches = dict(kern.launch_counts)
    probes = {t: bench_obs.probe_block(spec, "mesh", device)
              for t, spec in bench_obs.TOPOLOGIES.items()}
    return {"reports": reports, "launches": launches, "probes": probes} \
        if rank == 0 else None


def _audit_lines(lines):
    """The audit summary's numbers from launch.train's printed lines:
    {event: (ops, expected, dtypes, payload bytes)}, the WireStats bytes
    and whether it found nothing."""
    import re
    events, wire, clean = {}, None, False
    for line in lines:
        if not isinstance(line, str):
            continue
        m = re.match(r"\s*sync (\S+): (\d+) op\(s\) \(expected (\d+)\) "
                     r"dtypes=(\S+) payload=(\d+)B/worker", line)
        if m:
            events[m.group(1)] = (int(m.group(2)), int(m.group(3)),
                                  m.group(4), int(m.group(5)))
        m = re.match(r"\s*wire: (\d+)B/worker declared", line)
        if m:
            wire = int(m.group(1))
        clean |= line.strip() == "findings: none"
    return events, wire, clean


def analysis_phase(torch, kern, ref):
    """The analysis layer on the card (see the module docstring, 15).
    Returns the phase's record, with the kernels' launches per run under
    ``launches``."""
    from collections import Counter
    from repro_torch.analysis import (BUDGET_FILE, SyncPlanReport,
                                      check_reports, event_key, load_budget,
                                      round_key)
    from repro_torch.analysis.matrix import CONFIGS, build_engine
    from repro_torch.core import compile_schedule
    from repro_torch.experiments import bench_comms, bench_obs
    from repro_torch.launch.mesh import launch
    t_phase = time.perf_counter()
    card = card_line()
    budget = load_budget(ROOT / BUDGET_FILE)
    launches = {name: {} for name in kern.launch_counts}
    rec = {"card": card, "sim": {}, "mesh": {}}

    def note(label, counts):
        for name, n in counts.items():
            if n:
                launches[name][label] = n

    # (a) the sim configs: card against CPU, kernel regions, R3 on the card
    reports = []
    t0 = time.perf_counter()
    # the first switch into the warn mode reports a sync of its own
    _, rec["sync_mode_switch"] = _sync_warnings(torch, lambda: None)
    for config in (c for c in CONFIGS if c.startswith("sim/")):
        got = {}
        for dev in ("cpu", "cuda"):
            eng, state, batch_fn = build_engine(config, dev)
            kern.reset_launch_counts()
            got[dev] = eng.audit(state, batch_fn, config=config)
            if dev == "cuda":
                note(f"analysis audit {config}", kern.launch_counts)
        mine, cpu = got["cuda"], got["cpu"]
        check(mine.to_dict() == cpu.to_dict(),
              f"analysis {config}: the card's report differs from the "
              f"CPU's:\n{mine.summary()}\n{cpu.summary()}")
        reports.append(mine)
        schedule = eng.topology.schedule(eng.topology.periods[0])
        regions = {}
        for ev in dict.fromkeys(e for e in schedule if e is not None):
            kern.reset_launch_counts()
            summary = eng.executor.sync_program(ev, state)
            counts = {k: n for k, n in kern.launch_counts.items() if n}
            check(counts == dict(Counter(summary.kernels)),
                  f"analysis {config} {event_key(ev)}: launches {counts} "
                  f"but the recorded kernel regions {summary.kernels}")
            note(f"analysis sync {config} {event_key(ev)}", counts)
            regions[event_key(ev)] = list(summary.kernels)
        syncs = {}
        for rnd in dict.fromkeys(compile_schedule(schedule)):
            batches = tuple(eng._on_device(batch_fn(i), state)
                            for i in range(rnd.n_local))
            fn = eng.executor.round_fn(rnd)
            torch.cuda.synchronize()
            _, sites = _sync_warnings(torch, lambda: fn(state, batches))
            torch.cuda.synchronize()
            check(not sites, f"analysis {config} {round_key(rnd)}: the "
                  f"round body synchronizes with the host at {sites}, "
                  "where R3 found nothing")
            syncs[round_key(rnd)] = len(sites)
        rec["sim"][config] = {"report": mine.to_dict(),
                              "kernel_regions": regions,
                              "round_syncs": syncs}
        print(f"analysis {config}: card == CPU, kernel regions {regions} "
              f"== launches, sync warnings per round {syncs}; {card}",
              flush=True)
    rec["sim_s"] = time.perf_counter() - t0
    leg = {t: bench_obs.probe_op_leg(spec, "sim", "cuda")
           for t, spec in bench_obs.TOPOLOGIES.items()}
    rec["bench_obs_static"] = {"sim": leg}

    # (b) the mesh configs and bench_obs's mesh leg: one launch
    t0 = time.perf_counter()
    mesh = [c for c in CONFIGS if c.startswith("mesh/")]
    res = launch(analysis_mesh_rank, ANALYSIS_MESH_WORKERS, backend="gloo",
                 device="cuda", args=(mesh, budget, "cuda"),
                 timeout=MESH_TIMEOUT)
    rec["mesh_s"] = time.perf_counter() - t0
    note(f"analysis mesh audits (rank 0 of {ANALYSIS_MESH_WORKERS})",
         res["launches"])
    for d in res["reports"]:
        reports.append(SyncPlanReport.from_dict(d))
        rec["mesh"][d["config"]] = d
    rec["bench_obs_static"]["mesh"] = res["probes"]
    for backend, by_topo in rec["bench_obs_static"].items():
        for t, probes in by_topo.items():
            print(f"analysis bench_obs static leg {backend} {t}: "
                  + ", ".join(f"{k} +{d['extra_ops']} ops (budget "
                              f"{probes['budget']}), +{d['extra_callbacks']}"
                              f" callbacks, +{d['extra_transfers']} "
                              f"transfers" for k, d in
                              sorted(probes["rounds"].items()))
                  + f"; {card}", flush=True)
    regs, imps = check_reports(reports, budget)
    rec["check"] = {"configs": len(reports), "regressions": regs,
                    "improvements": imps}
    print(f"analysis: {len(reports)} card reports against {BUDGET_FILE}: "
          f"{len(regs)} regression(s), {len(imps)} improvement note(s) "
          f"(mesh launch {rec['mesh_s']:.1f} s); {card}", flush=True)
    check(len(reports) == len(CONFIGS) and not regs,
          f"analysis: the card's reports fail the budget: {regs}")

    # (c) launch.train --audit at full width
    t0 = time.perf_counter()
    argv = list(TRAIN_ARGV)
    argv[argv.index("--steps") + 1] = str(ANALYSIS_TRAIN_STEPS)
    kern.reset_launch_counts()
    history, lines = _train(argv + ["--audit"], "cuda")
    note("analysis train --audit (full width)", kern.launch_counts)
    events, wire, clean = _audit_lines(lines["other"])
    n = TRAIN_PARAMS
    want = {"sync_ops": 1, "payload_bytes": 4 * n,
            "wire_bytes": n + 4 * -(-n // ANALYSIS_INT8_BLOCK)}
    rec["train"] = {"events": events, "wire_payload_bytes": wire,
                    "clean": clean, "prediction": want,
                    "losses": [h["loss"] for h in history],
                    "wall_s": time.perf_counter() - t0}
    for key, (ops, expected, dtypes, payload) in sorted(events.items()):
        print(f"analysis train --audit qwen2-0.5b {key}: {ops} op(s) "
              f"(expected {expected}; predicted {want['sync_ops']}), "
              f"dtypes {dtypes}, payload {payload} B a worker (predicted "
              f"{want['payload_bytes']}); {card}", flush=True)
    print(f"analysis train --audit qwen2-0.5b: WireStats payload {wire} B a "
          f"worker (predicted {want['wire_bytes']}), findings "
          f"{'none' if clean else 'SOME'}, {rec['train']['wall_s']:.1f} s; "
          f"{card}", flush=True)
    check(clean and events and all(ops == expected for ops, expected, _, _
                                   in events.values())
          and all(math.isfinite(x) for x in rec["train"]["losses"]),
          f"analysis train --audit: {rec['train']}")

    # (d) bench_comms's twin with the wall-clock legs on the card
    t0 = time.perf_counter()
    kern.reset_launch_counts()
    twin = bench_comms.run(quick=True, measure=True, wall_clock=True,
                           device="cuda")
    note("analysis bench_comms --wall-clock", kern.launch_counts)
    bounds = bench_comms.check_wall_clock(twin)
    twin["wall_clock"]["bounds"] = bounds
    twin["wall_s"] = time.perf_counter() - t0
    rec["bench_comms"] = twin
    sim = twin["wall_clock"]["two_level"]["sim"]
    print("analysis bench_comms steps/s (best of "
          f"{bench_comms.WALL_REPEATS}): " + ", ".join(
              f"{k} {v['steps_per_sec_best']!r}" for k, v in sim.items())
          + f"; {card}", flush=True)
    print("analysis bench_comms sync latency (us): " + ", ".join(
        f"{k} {v!r}" for k, v in
        twin["wall_clock"]["sync_latency_us"].items())
        + f"; bounds {bounds}; {twin['wall_s']:.1f} s; {card}", flush=True)

    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"analysis phase: {rec['wall_s']:.1f} s (budget "
          f"{ANALYSIS_BUDGET_S}); {card}", flush=True)
    rec["launches"] = {k: v for k, v in launches.items() if v}
    return rec


# the roofline phase: the port's cost model (``repro_torch.roofline``)
# against the card.  Each priced call is timed (the median of ROOFLINE_REPS
# calls after a warm-up, a synchronize at each call's ends), then recorded
# once by ``analyze_program`` on copies of its arguments, with the launch
# counters from zero: qwen2-0.5b's prefill at full width (SERVE_BATCH x
# SERVE_PROMPT, float32 and bfloat16, with the attention kernel), the
# local, local-sync and global-sync steps of TRAIN_ARGV's training,
# amortized over its period by ``combine_train_steps``, and the global
# round of the quickstart world under int8 (host bound: priced in µs,
# measured in ms).  A bound above its measurement means a count or a rate
# is wrong and fails.  At TRAIN_ARGV with ROOFLINE_REDUCED
# (tests/test_dryrun_small.py's shape: 4 workers of 2 x 32 tokens,
# reduced qwen2-0.5b) the card's reports equal the CPU's in FLOPs by
# class, bytes and regions: the three steps and ``loss`` with the kernel.
# The phase should add under ROOFLINE_BUDGET_S (printed, not asserted)
ROOFLINE_REPS = 3
ROOFLINE_MESH = "h100x1"
ROOFLINE_OUT = ROOT / "build" / "roofline_card_torch.json"
ROOFLINE_REDUCED = ("--reduced", "--batch", "2", "--seq", "32")
# the step kinds of one H-SGD period: the sync level after the local step
ROOFLINE_KINDS = {"local": None, "local_sync": 2, "global_sync": 1}
ROOFLINE_BUDGET_S = 40.0
# PERF.md §6's bound column (ms): the functions' bounds at the timed
# shapes, which the kernels' work counts must reproduce
KERNEL_BOUNDS_MS = {
    "int8_quantize": 0.20095, "int8_dequantize": 0.20095,
    "int8_scale_quantize": 0.20095, "sign_pack": 0.16543,
    "sign_unpack": 0.16543, "topk_decode_reduce": 0.04007,
    "flash_attention bfloat16 (a)": 0.01521,
    "flash_attention bfloat16 (b)": 0.02606,
    "flash_attention bfloat16 (c)": 0.04347,
    "flash_attention bfloat16 (d)": 0.04006,
    "flash_attention float32 (a)": 0.11946,
    "flash_attention float32 (b)": 0.20647,
    "flash_attention float32 (c)": 0.33594,
    "flash_attention float32 (d)": 0.35890,
    "ssd_scan bfloat16": 0.01651, "ssd_scan float32": 0.10938,
    "rglru_scan": 0.07512,
}
KERNEL_BOUND_ATOL_MS = 5e-5


def kernel_bounds_ms(torch, kern, kattn, kssd, krg) -> dict:
    """The keys of KERNEL_BOUNDS_MS from the kernels' ``*_work`` counts:
    the codecs at (8, 2**24 + 77), the top-k reduce at TOPK_TIMED,
    attention at (a)-(d) in both dtypes, the scans at their full-width
    shapes."""
    r, c = SHAPES[1]
    out = {name: work_ms(getattr(kern, f"{name}_work")(r, c, BLOCK))[0]
           for name in ("int8_quantize", "int8_dequantize",
                        "int8_scale_quantize")}
    out.update({name: work_ms(getattr(kern, f"{name}_work")(
        r, c, SIGN_BLOCK))[0] for name in ("sign_pack", "sign_unpack")})
    out["topk_decode_reduce"] = work_ms(
        kern.topk_decode_reduce_work(*TOPK_TIMED))[0]
    for tag, at in zip("abcd", ATTN_CASES):
        b, sq, sk, hq, hk, d, _, causal, window = at[:9]
        for dtype in ("bfloat16", "float32"):
            out[f"flash_attention {dtype} ({tag})"] = work_ms(
                kattn.flash_attention_work(b, sq, sk, hq, hk, d,
                                           getattr(torch, dtype), causal,
                                           window))[0]
    for dtype in ("bfloat16", "float32"):
        out[f"ssd_scan {dtype}"] = work_ms(kssd.ssd_scan_work(
            *SSD_TIMED, getattr(torch, dtype)))[0]
    out["rglru_scan"] = work_ms(krg.rglru_scan_work(*RGLRU_CASES[-1]))[0]
    return out


def train_world(argv, device: str):
    """The engine that ``launch.train`` builds for ``argv``, its initial
    state on ``device``, the first batch of its token stream, the model's
    config and the parsed flags."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    from repro_torch.models import build_model
    args = train.build_argparser().parse_args(list(argv))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    spec = train.make_spec(args)
    eng = train.make_engine(args, model, spec)
    state = eng.init_from_params(
        train.init_params(model, args.seed, device), device=device)
    batch = train.make_stream(args, cfg.vocab_size, spec.n_workers,
                              device)(0)
    return eng, state, batch, cfg, args


def reduced_reports(device: str) -> dict:
    """At TRAIN_ARGV with ROOFLINE_REDUCED on ``device``: (FLOPs by class,
    bytes, regions) of each step kind's report and of the model's ``loss``
    with the kernels on one worker's batch."""
    import dataclasses
    from repro_torch.core import SyncEvent
    from repro_torch.models import build_model
    from repro_torch.roofline import analyze_program
    from repro_torch.tree import tree_map
    eng, st, batch, cfg, _ = train_world(TRAIN_ARGV + ROOFLINE_REDUCED,
                                         device)
    reps = {k: analyze_program(k, eng.step_fn(
        None if level is None else SyncEvent(level=level)), st, batch)
        for k, level in ROOFLINE_KINDS.items()}
    model = build_model(dataclasses.replace(cfg, use_kernels=True))
    reps["loss"] = analyze_program(
        "loss", model.loss, tree_map(lambda x: x[0], st.params),
        {k: v[0] for k, v in batch.items()})
    return {k: (r.flops_by_class, r.bytes_per_chip, r.regions)
            for k, r in reps.items()}


def _median_s(torch, fn, reps: int = ROOFLINE_REPS) -> float:
    """Median host seconds of ``reps`` calls of ``fn`` after one untimed,
    a ``synchronize`` at each call's two ends."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _roofline_line(label, rep, measured_s, card):
    """Print one priced call beside its measurement; fail if the bound is
    above it."""
    peak = rep.peak_memory_bytes
    print(f"roofline {label} ({card}): FLOPs by class "
          f"{rep.flops_by_class}, bytes {rep.bytes_per_chip!r}, regions "
          f"{rep.regions}; compute {rep.compute_s!r} s, memory "
          f"{rep.memory_s!r} s, collective {rep.collective_s!r} s, "
          f"dominant {rep.dominant}; bound {rep.step_s!r} s, measured "
          f"{measured_s!r} s, share {rep.step_s / measured_s!r}; useful "
          f"ratio {rep.useful_ratio!r}; peak "
          f"{None if peak is None else peak / 1e9!r} GB", flush=True)
    check(rep.step_s <= measured_s,
          f"roofline {label}: the bound {rep.step_s} s is above the "
          f"measured {measured_s} s: a count or a rate is wrong")


def _roofline_record(steps, head, measured_s, card, **extra):
    """One record of ``experiments.roofline_table``'s format, with the
    measurement beside it."""
    return {"steps": {k: r.asdict() for k, r in steps.items()},
            "terms_s": {"compute": head.compute_s, "memory": head.memory_s,
                        "collective": head.collective_s},
            "dominant": head.dominant, "useful_ratio": head.useful_ratio,
            "mapping": None, "n_workers": None, **extra,
            "measured_s": measured_s, "share": head.step_s / measured_s,
            "card": card}


def _priced(torch, counter, name, label, fn, *args, **kw):
    """(report, median seconds, launches of kernel ``name``) of ``fn(*args)``
    on the card: timed first, then recorded with ``counter``'s counts
    from zero, which must equal the report's regions of ``name``."""
    from repro_torch.roofline import analyze_program
    counter.reset_launch_counts()
    measured = _median_s(torch, lambda: fn(*args))
    timed = counter.launch_counts[name]
    counter.reset_launch_counts()
    rep = analyze_program(label, fn, *args, **kw)
    torch.cuda.synchronize()
    n = counter.launch_counts[name]
    check(n == rep.regions.get(name, 0),
          f"roofline {label}: {name} launched {n} times in the recorded "
          f"call, {rep.regions.get(name, 0)} regions priced")
    return rep, measured, timed + n


def roofline_phase(torch, kern, kattn, kssd, krg):
    """The cost model on the card (see the note at ROOFLINE_REPS): PERF.md
    §6's bounds from the work counts, the priced calls beside their
    measurements, the reduced reports card vs CPU; the records written to
    ROOFLINE_OUT and rendered by ``experiments.roofline_table``.  Returns
    the phase's record."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import SyncEvent, compile_schedule
    from repro_torch.experiments import roofline_table
    from repro_torch.models import build_model
    from repro_torch.roofline import combine_train_steps
    from repro_torch.roofline.analysis import model_flops_per_step
    t_phase = time.perf_counter()
    card = card_line()
    out = {"card": card, "launches": {"flash_attention": {},
                                      "int8_scale_quantize": {}}}
    bounds = kernel_bounds_ms(torch, kern, kattn, kssd, krg)
    for key, want in KERNEL_BOUNDS_MS.items():
        check(abs(bounds[key] - want) <= KERNEL_BOUND_ATOL_MS,
              f"{key}: the work count gives a bound of {bounds[key]} ms, "
              f"PERF.md's table {want} ms")
    out["kernel_bounds_ms"] = bounds
    print(f"roofline: PERF.md's bounds from the work counts (ms): {bounds}",
          flush=True)
    results = {}

    # qwen2-0.5b's prefill at full width, with the attention kernel
    base = dataclasses.replace(get_config("qwen2-0.5b"), use_kernels=True)
    shape = InputShape("prefill", SERVE_PROMPT, SERVE_BATCH, "prefill")
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = model.init(gen, device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                               generator=gen, device="cuda")
        label = f"qwen2-0.5b prefill {dtype}"

        def prefill(p, t):
            return model.prefill(p, t, max_len=SERVE_PROMPT)

        rep, measured, n = _priced(
            torch, kattn, "flash_attention", label, prefill, params, tokens,
            model_flops=model_flops_per_step(cfg, shape))
        check(rep.regions.get("flash_attention") == cfg.num_layers,
              f"roofline {label}: {rep.regions} regions for "
              f"{cfg.num_layers} layers")
        _roofline_line(label, rep, measured, card)
        out["launches"]["flash_attention"][f"roofline {label}"] = n
        results[f"qwen2-0.5b|prefill_{SERVE_BATCH}x{SERVE_PROMPT}_{dtype}|"
                f"{ROOFLINE_MESH}"] = _roofline_record(
                    {"prefill": rep}, rep, measured, card)
        del model, params, tokens, rep
        torch.cuda.empty_cache()

    # one H-SGD period of TRAIN_ARGV's training, step kind by step kind
    eng, state, batch, cfg, args = train_world(TRAIN_ARGV, "cuda")
    n_workers = eng.topology.n
    mf = model_flops_per_step(cfg, InputShape(
        "train", args.seq, args.batch * n_workers, "train"))
    reports, measured = {}, {}
    for kname, level in ROOFLINE_KINDS.items():
        ev = None if level is None else SyncEvent(level=level)
        label = f"qwen2-0.5b train {kname}"
        reports[kname], measured[kname], n = _priced(
            torch, kern, "int8_scale_quantize", label, eng.step_fn(ev),
            state, batch, model_flops=mf)
        check((n > 0) == (ev is not None),
              f"roofline {label}: int8_scale_quantize launched {n} times")
        _roofline_line(label, reports[kname], measured[kname], card)
        if n:
            out["launches"]["int8_scale_quantize"][f"roofline {label}"] = n
        torch.cuda.empty_cache()
    G, I = args.G, args.I
    amortized = combine_train_steps(reports, G, I)
    amortized["bound_s"] = max(amortized[t] for t in (
        "compute_s", "memory_s", "collective_s"))
    amortized["measured_s"] = ((G - G // I) * measured["local"]
                               + (G // I - 1) * measured["local_sync"]
                               + measured["global_sync"]) / G
    amortized["share"] = amortized["bound_s"] / amortized["measured_s"]
    print(f"roofline qwen2-0.5b train, amortized over G = {G}, I = {I} "
          f"({card}): {amortized}", flush=True)
    check(amortized["bound_s"] <= amortized["measured_s"],
          f"roofline train amortized: the bound {amortized['bound_s']} s is "
          f"above the measured {amortized['measured_s']} s")
    key = (f"qwen2-0.5b|train_{n_workers}x{args.batch}x{args.seq}_int8|"
           f"{ROOFLINE_MESH}")
    results[key] = _roofline_record(
        reports, reports["global_sync"], measured["global_sync"], card,
        mapping="replica", n_workers=n_workers, amortized=amortized,
        measured_by_step_s=measured)
    del eng, state, batch, reports
    torch.cuda.empty_cache()

    # the global round of the quickstart world under int8
    engine, qstate, ds, _ = quickstart_world("cuda", "int8")
    G = engine.topology.periods[0]
    rounds, t0 = compile_schedule(engine.topology.schedule(G)), 0
    for rnd in rounds:
        if rnd.event is not None and rnd.event.level == 1:
            break
        t0 += rnd.n_local
    batches = tuple(engine._on_device(ds.batch(t, 10), qstate)
                    for t in range(t0, t0 + rnd.n_local))
    label = "quickstart global round int8"
    rep, q_measured, n = _priced(torch, kern, "int8_scale_quantize", label,
                                 engine.round_fn(rnd), qstate, batches)
    check(n > 0, f"roofline {label}: int8_scale_quantize never launched")
    _roofline_line(label, rep, q_measured, card)
    out["launches"]["int8_scale_quantize"][f"roofline {label}"] = n
    results[f"quickstart|round_{rnd.n_local}_int8|{ROOFLINE_MESH}"] = \
        _roofline_record({"round": rep}, rep, q_measured, card)

    # the reduced training and loss: card against CPU
    same = {device: reduced_reports(device) for device in ("cuda", "cpu")}
    for k, card_rep in same["cuda"].items():
        print(f"roofline reduced {k}: card {card_rep}, CPU "
              f"{same['cpu'][k]}", flush=True)
        check(card_rep == same["cpu"][k],
              f"roofline reduced {k}: the card's report {card_rep} is not "
              f"the CPU's {same['cpu'][k]}")
    out["reduced"] = same["cuda"]

    roofline_table.save(results, str(ROOFLINE_OUT))
    rows = roofline_table.main(path=str(ROOFLINE_OUT))
    check(len(rows) == len(results),
          f"roofline_table rendered {len(rows)} rows of {len(results)}")
    out["records"] = results
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"roofline phase: {out['wall_s']:.1f} s (budget "
          f"{ROOFLINE_BUDGET_S} s)", flush=True)
    return out


# 15b. the dry run on the card (``repro_torch.launch.dryrun``): rank 0's
# program of DRYRUN_ARCH on the production mesh (data=16, model=16) under
# torch's fake process group (its collectives return without data; the
# compute is real).  prefill_32k with the attention kernel (2 sequences of
# 32,768 tokens a rank, GQA 14/2 heads, D = 64) in the config's bfloat16,
# and decode_32k, each materialized on the card (rank
# 0's shards, the params' from a full init) and recorded on ``meta`` too:
# the two reports must be equal, the kernel's launches equal its regions,
# each bound at most its measurement (median of ROOFLINE_REPS after a
# warm-up).  The kernel is held against its plain version at this shape on
# DRYRUN_SLICE, which the plain version's (S x S) logits fit, in float32
# and bfloat16.  The pairs
# that cannot be materialized (train_4k: with the kernels off, as the
# reference's dry run has them, the saved attention scores alone are ~15 GB
# a layer) are recorded on ``meta`` by ``python -m repro_torch.launch.
# dryrun`` in child processes meanwhile, on the host's other cores.  The
# four records go to DRYRUN_OUT and ``roofline_table`` renders them.
DRYRUN_ARCH = "qwen2-0.5b"
DRYRUN_OUT = ROOT / "build" / "dryrun_torch.json"
DRYRUN_PARTS = ROOT / "build" / "dryrun_parts"
DRYRUN_META_PAIRS = (("train_4k", "single"), ("train_4k", "multi"))
DRYRUN_SLICE = (1, 32768, 2, 1, 64)      # (B, S, Hq, Hk, D)
DRYRUN_CHILD_TIMEOUT = 600.0
DRYRUN_BUDGET_S = 40.0
# hillclimb phase: the hillclimb's twin (``repro_torch.experiments.
# hillclimb``) on the card's torch for the reference's qwen2-0.5b|train_4k
# pair, its iterations recorded on ``meta`` under the fake world of 512
# ranks, one child process an iteration, started with the first of the
# HILLCLIMB_BESIDE phases that runs (on the host's other cores while the
# card runs those phases), or by the phase itself when run alone.  Every
# iteration must be recorded without error; dp_only+bf16_sync's
# global-sync param all-reduce must move exactly half of dp_only's (2 B a
# param for 4); dp_only's rank-0 params must be the whole params (2 B a
# param in bfloat16): with model_shard off nothing is left sharded over
# 'model'
HILLCLIMB_PAIR = "qwen2-0.5b|train_4k"
HILLCLIMB_OUT = ROOT / "build" / "hillclimb_torch.json"
HILLCLIMB_PARTS = ROOT / "build" / "hillclimb_parts"
HILLCLIMB_CHILD_TIMEOUT = 900.0
HILLCLIMB_BESIDE = ("roofline", "dryrun")
_hillclimb_children = {}


def _dryrun_children():
    """Start one ``python -m repro_torch.launch.dryrun`` per meta pair."""
    DRYRUN_PARTS.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    procs = {}
    for shape, mesh in DRYRUN_META_PAIRS:
        out = DRYRUN_PARTS / f"{shape}_{mesh}.json"
        procs[out] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRYRUN_ARCH, "--shape", shape, "--mesh", mesh, "--force",
             "--out", str(out)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def start_hillclimb():
    """Start one ``python -m repro_torch.experiments.hillclimb`` child per
    iteration of HILLCLIMB_PAIR, once; the children by iteration name."""
    import shutil
    from repro_torch.experiments import hillclimb
    if _hillclimb_children:
        return _hillclimb_children
    shutil.rmtree(HILLCLIMB_PARTS, ignore_errors=True)
    HILLCLIMB_PARTS.mkdir(parents=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    for name, *_ in hillclimb.ITERATIONS[HILLCLIMB_PAIR]:
        out = HILLCLIMB_PARTS / f"{name}.json"
        _hillclimb_children[name] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.experiments.hillclimb",
             "--pair", HILLCLIMB_PAIR.split("|")[0], "--name", name,
             "--force", "--limit-s", str(HILLCLIMB_CHILD_TIMEOUT - 60),
             "--out", str(out)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return _hillclimb_children


def hillclimb_phase(torch):
    """The hillclimb leg (see the note at HILLCLIMB_PAIR); returns its
    record."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    children = dict(start_hillclimb())
    records, logs = {}, {}
    try:
        for name, (path, proc) in children.items():
            logs[name], _ = proc.communicate(
                timeout=HILLCLIMB_CHILD_TIMEOUT)
            check(proc.returncode == 0, f"hillclimb {name}: exited "
                  f"{proc.returncode}:\n{logs[name][-3000:]}")
            records.update(json.loads(path.read_text()))
    finally:
        for _, proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        _hillclimb_children.clear()
    HILLCLIMB_OUT.write_text(json.dumps(records, indent=1))
    key = f"{HILLCLIMB_PAIR}|{{}}".format
    check(len(records) == len(children) and not any(
        "error" in r for r in records.values()),
          f"hillclimb: records {sorted(records)} or an error in them")

    def sync_all_reduce(name):
        steps = records[key(name)]["steps"]
        return steps["global_sync"]["coll_by_kind"]["all-reduce"] \
            - steps["local"]["coll_by_kind"]["all-reduce"]
    cfg = get_config(HILLCLIMB_PAIR.split("|")[0])
    n_params = cfg.param_count()
    embed = cfg.vocab_size * cfg.d_model
    dp, dp16 = sync_all_reduce("dp_only"), \
        sync_all_reduce("dp_only+bf16_sync")
    held = records[key("dp_only")]["rank0_param_bytes"]
    # DTensor may return a leaf's update sharded like its gradient (on
    # torch 2.13 the tied embedding's, over 'model' by the vocabulary): the
    # sync then moves that leaf's shard, and the pin gathers it after
    print(f"hillclimb: global-sync param all-reduce dp_only {dp!r} B, "
          f"dp_only+bf16_sync {dp16!r} B (hand: the whole params "
          f"{4 * n_params}, or with the embedding's update sharded over "
          f"'model' {4 * (n_params - embed) + 4 * embed // 16}); dp_only's "
          f"rank-0 params {held} B (hand: {2 * n_params})", flush=True)
    check(dp > 0 and dp16 * 2 == dp,
          f"hillclimb: the global sync all-reduces {dp} B (f32) and {dp16} "
          f"B (bf16); want the second half the first")
    check(held == 2 * n_params, f"hillclimb: dp_only's rank 0 holds {held} "
          f"B of params; want the whole params, {2 * n_params}")
    out = {"records": records}
    for k, r in records.items():
        a = r["amortized"]
        print(f"hillclimb {k}: amortized compute {a['compute_s']!r} s, "
              f"memory {a['memory_s']!r} s, collective "
              f"{a['collective_s']!r} s ({a['dominant']}); rank-0 resident "
              f"{r['rank0_resident_gb']!r} GB; collective GB intra "
              f"{r['coll_intra_gb']!r}, cross {r['coll_cross_gb']!r}; "
              f"recorded in {r['wall_s']} s", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"hillclimb phase: {out['wall_s']:.1f} s of waiting", flush=True)
    return out


def _dryrun_slice(torch, kattn, ref):
    """``flash_attention`` against ``attention_ref`` at the phase's
    sequence length on DRYRUN_SLICE, in both dtypes: max |diff|."""
    b, s, hq, hk, d = DRYRUN_SLICE
    errs = {}
    for dtype in ("float32", "bfloat16"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(getattr(torch, dtype)) for h in (hq, hk, hk))
        got = kattn.flash_attention(q, k, v, causal=True)
        want = ref.attention_ref(q, k, v, causal=True)
        errs[dtype] = (got.float() - want.float()).abs().max().item()
        check(errs[dtype] <= ATTN_TOL[dtype],
              f"dryrun: flash_attention {dtype} at {DRYRUN_SLICE} lies "
              f"{errs[dtype]} from its plain version (tolerance "
              f"{ATTN_TOL[dtype]})")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return errs


def _dryrun_pair(torch, kattn, D, cfg, shape, mesh, card):
    """One pair on the card: its meta report, its card report (timed,
    then recorded with the launch counter from zero) and its record."""
    program = {"prefill": D.prefill_program,
               "decode": D.decode_program}[shape.kind]
    label = f"dryrun {cfg.name} {shape.name} {cfg.dtype}"
    mf = D.model_flops_per_chip(cfg, shape, mesh)
    meta = D.price(label, program(cfg, shape, mesh), mesh, mf)
    t0 = time.perf_counter()
    prog = program(cfg, shape, mesh, seed=0)
    rep, measured, n = _priced(torch, kattn, "flash_attention", label,
                               prog.fn, *prog.args, top_axis="pod",
                               model_flops=mf)
    record_s = time.perf_counter() - t0
    want = cfg.num_layers if shape.kind == "prefill" else 0
    check(rep.regions.get("flash_attention", 0) == want,
          f"{label}: {rep.regions} regions for {want} attention calls")
    fields = ("flops_by_class", "bytes_per_chip", "coll_intra", "coll_cross",
              "regions")
    got, wanted = ({f: getattr(r, f) for f in fields} for r in (rep, meta))
    print(f"{label}: card {got}, meta {wanted}", flush=True)
    check(got == wanted, f"{label}: the card's report {got} is not the meta "
          f"report {wanted}")
    print(f"{label}: collective bytes intra {rep.coll_intra!r}, cross "
          f"{rep.coll_cross!r}, by kind {rep.coll_by_kind}", flush=True)
    _roofline_line(label, rep, measured, card)
    rec = D.make_record(cfg.name, shape, False, {
        shape.kind: rep, "_resident": prog.resident_bytes}, record_s, 256)
    rec.update(measured_s=measured, share=rep.step_s / measured, card=card)
    del prog
    torch.cuda.empty_cache()
    return rec, n


def dryrun_phase(torch, kattn, ref):
    """The dry run on the card (see the note at DRYRUN_ARCH); returns the
    phase's record."""
    import dataclasses
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.experiments import roofline_table
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    t_phase = time.perf_counter()
    card = card_line()
    out = {"card": card, "launches": {"flash_attention": {}}}
    children = _dryrun_children()
    try:
        out["slice_max_abs_err"] = _dryrun_slice(torch, kattn, ref)
        base = dataclasses.replace(get_config(DRYRUN_ARCH), use_kernels=True)
        results, shares = {}, {}
        with D.fake_world(256):
            mesh = make_production_mesh(False, device_type="cuda")
            # prefill_32k in float32 too, priced whole: its attention
            # regions by the kernel's design (the split pre-pass, then
            # 24*D products on the tensor cores)
            for sname, dtype in (("prefill_32k", base.dtype),
                                 ("prefill_32k", "float32"),
                                 ("decode_32k", base.dtype)):
                cfg = dataclasses.replace(base, dtype=dtype,
                                          param_dtype=dtype)
                rec, n = _dryrun_pair(torch, kattn, D, cfg,
                                      INPUT_SHAPES[sname], mesh, card)
                if n:
                    out["launches"]["flash_attention"][
                        f"dryrun {sname} {dtype}"] = n
                shares[f"{sname} {dtype}"] = rec["share"]
                if dtype == base.dtype:
                    results[f"{DRYRUN_ARCH}|{sname}|single"] = rec
        for path, proc in children.items():
            log, _ = proc.communicate(timeout=DRYRUN_CHILD_TIMEOUT)
            check(proc.returncode == 0, f"dryrun: {' '.join(proc.args)} "
                  f"exited {proc.returncode}:\n{log[-3000:]}")
            results.update(roofline_table.load(str(path)))
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(not torch.distributed.is_initialized(),
          "dryrun: the fake process group outlived the phase")
    roofline_table.save(results, str(DRYRUN_OUT))
    rows = roofline_table.main(path=str(DRYRUN_OUT))
    check(len(rows) == len(results) == 2 + len(DRYRUN_META_PAIRS),
          f"dryrun: roofline_table rendered {len(rows)} rows of "
          f"{len(results)}")
    out["records"] = results
    out["shares"] = shares
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"dryrun phase: {out['wall_s']:.1f} s (budget {DRYRUN_BUDGET_S} "
          "s)", flush=True)
    return out


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


# the phases, in the order a run with no --phase takes them
PHASES = ("kernels", "main_path", "topk_kernel", "topk_sim", "mesh",
          "attention", "serving", "ssm_kernel", "ssm_forward", "ssm_serving",
          "moe_encdec", "experiments", "examples", "runtime", "obs",
          "population", "train", "analysis", "roofline", "dryrun",
          "hillclimb")


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(
        prog="chip_smoke.py",
        description="smoke test of the PyTorch port on one CUDA card")
    ap.add_argument("--profile", action="store_true",
                    help="only the serving profile (attention kernel)")
    ap.add_argument("--phase", default=None, type=lambda v: [
        p for p in v.split(",") if p],
        help="run only these phases, comma-separated, of: "
             + ", ".join(PHASES))
    args = ap.parse_args(argv)
    if args.phase is not None:
        bad = [p for p in args.phase if p not in PHASES]
        if bad or not args.phase:
            ap.error(f"--phase: unknown {bad}; the phases are "
                     f"{', '.join(PHASES)}")
        args.phase = [p for p in PHASES if p in args.phase]
    return args


def codec_kernel_phases(torch, kern, ref):
    """The int8 and sign kernel phases, their times printed."""
    recs = kernel_phase(torch, kern, ref)
    recs.update(sign_kernel_phase(torch, kern, ref))
    for name, rec in recs.items():
        for shape in SHAPES:
            t = rec[shape]
            print(f"{name} {shape}: kernel {t['ms']:.5f} ms, plain "
                  f"{t['plain_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms",
                  flush=True)
    return recs


def _jsonable(obj):
    """A phase's record as JSON data: tuple keys as strings."""
    if isinstance(obj, dict):
        return {(k if isinstance(k, str) else str(k)): _jsonable(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def _analysis_line(rec):
    """The analysis phase's printed line: each config's budget projection
    instead of its full report (the file keeps the reports)."""
    from repro_torch.analysis import SyncPlanReport, entry_from_report
    out = {k: v for k, v in rec.items()
           if k not in ("launches", "sim", "mesh")}
    out["configs"] = {}
    for d in [v["report"] for v in rec["sim"].values()] \
            + list(rec["mesh"].values()):
        out["configs"][d["config"]] = entry_from_report(
            SyncPlanReport.from_dict(d))
    out["bench_comms"] = {"wall_clock": rec["bench_comms"]["wall_clock"],
                          "wall_s": rec["bench_comms"]["wall_s"]}
    return _jsonable(out)


def main() -> int:
    # the train phase's deterministic algorithms need cuBLAS's fixed
    # workspaces, which cuBLAS reads when CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import comms as kern
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as krg
    from repro_torch.kernels import ssd_scan as kssd

    # TF32 rule: float32 products and convolutions in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = parse_args(sys.argv[1:])
    if args.profile:
        print(card_line(), flush=True)
        _build.build("flash_attention")
        print(json.dumps({"profile": profile_phase(torch, kattn)}))
        return 0
    chosen = PHASES if args.phase is None else args.phase
    phases = {
        "kernels": lambda: codec_kernel_phases(torch, kern, ref),
        "main_path": lambda: main_path_phase(torch, kern, ref),
        "topk_kernel": lambda: topk_kernel_phase(torch, kern, ref),
        "topk_sim": lambda: topk_sim_phase(torch),
        "mesh": lambda: mesh_phase(torch),
        "attention": lambda: attention_kernel_phase(torch, kattn, ref),
        "serving": lambda: serving_phase(torch, kern, kattn, ref),
        "ssm_kernel": lambda: ssm_kernel_phase(torch, kssd, krg, ref),
        "ssm_forward": lambda: ssm_forward_phase(torch, kern, kattn, kssd,
                                                 krg, ref),
        "ssm_serving": lambda: ssm_serving_phase(torch, kern, kattn, kssd,
                                                 krg, ref),
        "moe_encdec": lambda: moe_encdec_phase(torch, kern, kattn, ref),
        "experiments": lambda: experiments_phase(torch,
                                                 (kern, kattn, kssd, krg)),
        "examples": lambda: examples_phase(torch, kern, kattn, ref),
        "runtime": lambda: runtime_phase(torch, kern, ref),
        "obs": lambda: obs_phase(torch, kern, ref),
        "population": lambda: population_phase(torch, kern, ref),
        "train": lambda: train_phase(torch, kern, ref),
        "analysis": lambda: analysis_phase(torch, kern, ref),
        "roofline": lambda: roofline_phase(torch, kern, kattn, kssd, krg),
        "dryrun": lambda: dryrun_phase(torch, kattn, ref),
        "hillclimb": lambda: hillclimb_phase(torch),
    }
    assert tuple(phases) == PHASES
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
        res = {}
        for name in chosen:
            if name in HILLCLIMB_BESIDE and "hillclimb" in chosen:
                start_hillclimb()
            t0 = time.perf_counter()
            res[name] = phases[name]()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if args.phase is not None:
        # the named phases' records only: the kernels line needs them all
        records = [{name: _jsonable(res[name])} for name in chosen]
        (out_dir / "chip_smoke_phases.json").write_text(
            json.dumps({"card": card_line(), "records": records}, indent=1))
        for rec in records:
            print(json.dumps(rec))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    recs, launches = res["kernels"], res["main_path"]
    topk, topk_sim, mesh = res["topk_kernel"], res["topk_sim"], res["mesh"]
    attn, served, ssm = res["attention"], res["serving"], res["ssm_kernel"]
    ssm_fwd, ssm_served = res["ssm_forward"], res["ssm_serving"]
    moe_encdec, experiments = res["moe_encdec"], res["experiments"]
    examples = res["examples"]
    runtime, obs, population = res["runtime"], res["obs"], res["population"]
    trained, analysis = res["train"], res["analysis"]
    roofline, dryrun, hillclimb = res["roofline"], res["dryrun"], \
        res["hillclimb"]
    for phase in (mesh, runtime, obs, population, trained, analysis):
        for name, by_run in phase["launches"].items():
            launches[name].update(by_run)
    launches["int8_scale_quantize"].update(
        examples["launches"]["int8_scale_quantize"])
    launches["int8_scale_quantize"].update(
        roofline["launches"]["int8_scale_quantize"])
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
    topk_runs.update({f"mesh {label} (each of {MESH_WORKERS} ranks)":
                      rec["launches_per_rank"]["topk_decode_reduce"][0]
                      for label, rec in mesh["a7d"]["runs"].items()
                      if "topk_decode_reduce" in rec["launches_per_rank"]})
    train_topk = {f"train mesh topk (each of {TRAIN_MESH_WORKERS} ranks)":
                  trained["mesh"]["topk_per_rank"][0]}
    kernels.append({
        "name": "topk_decode_reduce", "route": "cuda",
        "source": SOURCE.format("topk_reduce"), "replaces": TOPK_TPU_KERNEL,
        "launches": MESH_WORKERS * sum(topk_runs.values())
        + sum(trained["mesh"]["topk_per_rank"]),
        "launches_by_run": {**topk_runs, **train_topk},
        "max_abs_err": topk["max_abs_err"],
        "max_abs_err_repeated": topk["max_abs_err_repeated"],
        "ms": topk["ms"], "plain_ms": topk["plain_ms"],
        "bound_ms": topk["bound_ms"], "bound_by": topk["bound_by"],
        "library_ms": topk["library_ms"], "library": "index_add_",
        "shape": topk["shape"],
    })
    a, b, c, d = attn["timed"]

    # launches of each LM kernel, by run: serving, then the SSM loss and
    # serving runs
    def runs_of(name):
        return {label: c[name] for runs in (ssm_fwd, ssm_served)
                for label, c in runs["launches"].items() if c[name]}

    attn_runs = {**served["launches"], **runs_of("flash_attention"),
                 **moe_encdec["launches"],
                 **examples["launches"]["flash_attention"],
                 **roofline["launches"]["flash_attention"],
                 **dryrun["launches"]["flash_attention"]}
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
        "shape": a["shape"], "shape_b": b, "shape_c": c, "shape_d": d,
        "max_abs_err_f32": attn["max_abs_err_f32"],
        "f32_ulps_max": attn["f32_ulps_max"], "f32_ulps_limit": ATTN_F32_ULPS,
        "float32": dict(zip("abcd", attn["timed_f32"])),
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
    records = [
        {"ssm": {"loss": ssm_fwd["throughput"],
                 "serving": ssm_served["throughput"]}},
        {"moe_encdec": {k: v for k, v in moe_encdec.items()
                        if k != "launches"}},
        {"topk_sim": topk_sim, "mesh": mesh},
        {"experiments": {k: v for k, v in experiments.items()
                         if k != "mains"}},
        {"examples": {k: v for k, v in examples.items()
                      if k not in ("twins", "launches")}},
        {"runtime": {k: v for k, v in runtime.items() if k != "launches"}},
        {"obs": {k: v for k, v in obs.items() if k != "launches"}},
        {"population": {k: v for k, v in population.items()
                        if k != "launches"}},
        {"train": {k: v for k, v in trained.items() if k != "launches"}},
        {"analysis": _analysis_line(analysis)},
        {"roofline": {k: v for k, v in roofline.items()
                      if k not in ("launches", "records")}},
        {"dryrun": {k: v for k, v in dryrun.items()
                    if k not in ("launches", "records")}},
        {"hillclimb": {k: v for k, v in hillclimb.items()
                       if k != "records"}},
        {"kernels": kernels}]
    # the whole record also in a file: the lines outgrow a terminal's tail
    (out_dir / "chip_smoke.json").write_text(
        json.dumps({"card": card_line(), "records": records}, indent=1))
    for rec in records:
        print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
