#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of JAX
or of the JAX package.  It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/`` and prints what ``ptxas`` reports;
3. kernel phase: holds every kernel bitwise against its plain PyTorch
   version on the card, at the main path's shape (8, 2120) and at
   (8, 2**24 + 77) with a ragged tail, block 256, one all-zero row; times
   kernel and plain version with CUDA events (median of >= 20 runs after
   warm-up) beside the bound (bytes moved / 3.35 TB/s);
4. main path phase: runs the quickstart world (two_level n=8 N=2 G=16
   I=4, MLP 24-32-8, sgd(0.08), batch 10, T=96) through ``HSGD.run_rounds``
   on ``cuda`` with ``comms="int8"`` (wire path) and with
   ``Comms("int8", wire_reduce=False)`` (legacy roundtrip), counting kernel
   launches from zero for each run; requires every kernel of the run to
   have launched, the same trajectory bit for bit as the same run with
   the plain versions on the card, accuracy >= 0.9, the same wire bytes
   as the same run on the CPU, and a final loss within LOSS_RTOL relative
   of the CPU run;
5. prints one ``{"kernels": [...]}`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Any failed phase exits non-zero before the result line.
"""
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BLOCK = 256
SHAPES = ((8, 2120), (8, 2**24 + 77))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# card vs CPU final loss.  The int8 codec is bitwise the same on both
# devices, but PyTorch's CPU and CUDA float32 ops differ in the last bit
# inside the local updates, and an ulp can flip one int8 rounding, which
# moves that element by a whole quantum: the wire path measured 2.24e-4
# on an H100 (PERF.md), against 3e-3 between int8 and comms off.  The
# kernels themselves are held bitwise in the main path against the plain
# versions on the card.
LOSS_RTOL = 1e-3
MIN_ACC = 0.9
TPU_KERNEL = "src/repro/kernels/comms.py"
SOURCE = "src/repro_torch/kernels/csrc/int8_codec.cu"


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


def bound_ms(n_bytes: int, n_ops: int):
    """Least time for the work: the larger of bytes over the memory rate
    and float32 operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def quickstart(device: str, comms):
    """The quickstart world through HSGD.run_rounds; returns the final
    global loss and accuracy, the wire bytes, the launch counts of the
    run, its seconds and the final worker params (on the CPU)."""
    import torch
    from repro_torch.core import EngineConfig, HSGD, make_topology
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
    topo = make_topology("two_level", n=8, N=2, G=16, I=4)
    engine = HSGD(model.loss, sgd(0.08), topo, EngineConfig(comms=comms))
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
    return {"loss": last["loss"], "acc": last["acc"],
            "wire_bytes": sum(r.get("wire_bytes", 0) for r in history),
            "launches": counts, "seconds": seconds,
            "params": [p.cpu() for p in tree_leaves(state.params)]}


@contextlib.contextmanager
def plain_versions(kern, ref):
    """Route the kernel wrappers to their plain PyTorch versions on the
    card, for a run to hold the kernels' run against."""
    saved = (kern.int8_quantize, kern.int8_dequantize,
             kern.int8_scale_quantize)
    kern.int8_quantize = lambda x, block=BLOCK: ref.int8_ref(x, block)[:2]
    kern.int8_dequantize = \
        lambda q, s, block=BLOCK: ref.int8_dequant_ref(q, s, block)
    kern.int8_scale_quantize = \
        lambda x, s, block=BLOCK: ref.int8_scale_quant_ref(x, s, block)
    try:
        yield
    finally:
        (kern.int8_quantize, kern.int8_dequantize,
         kern.int8_scale_quantize) = saved


def main_path_phase(torch, kern, ref):
    """Both int8 paths on the card: with the kernels (launches counted),
    with the plain versions on the card (must give the same trajectory bit
    for bit), and on the CPU (same wire bytes, final loss within
    LOSS_RTOL).  Returns the launch counts of each kernel from the run
    that uses it."""
    from repro_torch.comms import Comms
    runs = (("int8", lambda: "int8", ("int8_scale_quantize",)),
            ("int8 legacy", lambda: Comms("int8", wire_reduce=False),
             ("int8_quantize", "int8_dequantize")))
    launches = {}
    for label, make, kernels in runs:
        gpu = quickstart("cuda", make())
        with plain_versions(kern, ref):
            plain = quickstart("cuda", make())
        cpu = quickstart("cpu", make())
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
            launches[name] = gpu["launches"][name]
        check(not any(plain["launches"].values()),
              f"{label}: the plain-version run launched a kernel")
        check(all(torch.equal(a, b)
                  for a, b in zip(gpu["params"], plain["params"]))
              and gpu["loss"] == plain["loss"],
              f"{label}: the kernels' trajectory differs from the plain "
              "versions' on the card")
        check(math.isfinite(gpu["loss"]), f"{label}: loss is not finite")
        check(min(gpu["acc"], cpu["acc"]) >= MIN_ACC,
              f"{label}: accuracy {gpu['acc']} (cuda) {cpu['acc']} (cpu) "
              f"< {MIN_ACC}")
        check(gpu["wire_bytes"] == cpu["wire_bytes"],
              f"{label}: wire bytes {gpu['wire_bytes']} on cuda, "
              f"{cpu['wire_bytes']} on cpu")
        check(rel <= LOSS_RTOL,
              f"{label}: loss {gpu['loss']} on cuda vs {cpu['loss']} on "
              f"cpu, relative difference {rel} > {LOSS_RTOL}")
    return launches


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
    from repro_torch.kernels import comms as kern
    from repro_torch.kernels import ref

    # TF32 rule: float32 products and convolutions in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        print(card_line(), flush=True)
        t0 = time.perf_counter()
        lib = _build.build("int8_codec", verbose=True)
        print(f"built {lib.relative_to(ROOT)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        recs = kernel_phase(torch, kern, ref)
        for name, rec in recs.items():
            for shape in SHAPES:
                t = rec[shape]
                print(f"{name} {shape}: kernel {t['ms']:.5f} ms, plain "
                      f"{t['plain_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms",
                      flush=True)
        launches = main_path_phase(torch, kern, ref)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, replaces in (("int8_quantize", 68), ("int8_dequantize", 94),
                           ("int8_scale_quantize", 120)):
        rec = recs[name]
        big, small = rec[SHAPES[1]], rec[SHAPES[0]]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{TPU_KERNEL}:{replaces}",
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": None, "shape": list(SHAPES[1]),
            "main_path_shape": {"shape": list(SHAPES[0]), **small},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
