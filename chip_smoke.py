#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of JAX
or of the JAX package.  It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/``, one ``nvcc`` per source, all started together, and
   prints what ``ptxas`` reports;
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = ("int8_codec", "sign_codec")
BLOCK = 256
SHAPES = ((8, 2120), (8, 2**24 + 77))
SIGN_BLOCK = 1024
# (shape, block) of the sign kernel checks; the first two are timed
SIGN_CASES = (((8, 2120), SIGN_BLOCK), ((8, 2**24 + 77), SIGN_BLOCK),
              ((8, 2120), 64), ((8, 2120), 1000), ((8, 2120), 24))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
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


def quickstart(device: str, comms, spec=None, opt=None):
    """The quickstart world through HSGD.run_rounds, on the two-level
    hierarchy or ``spec`` (group sizes, periods), with sgd(0.08) or
    ``opt``; returns the final global loss and accuracy, the wire bytes,
    the launch counts of the run, its seconds and the final worker params
    (on the CPU)."""
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
                  EngineConfig(comms=comms))
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
    plain = {
        "int8_quantize": lambda x, block: ref.int8_ref(x, block)[:2],
        "int8_dequantize": lambda q, s, block: ref.int8_dequant_ref(
            q, s, block),
        "int8_scale_quantize": lambda x, s, block:
            ref.int8_scale_quant_ref(x, s, block),
        "sign_pack": lambda x, block: ref.sign_pack_ref(x, block),
        "sign_unpack": lambda b, s, size, block: ref.sign_unpack_ref(
            b, s, size, block),
    }
    saved = {name: getattr(kern, name) for name in plain}
    for name, fn in plain.items():
        setattr(kern, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kern, name, fn)


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
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            libs = list(pool.map(
                lambda name: _build.build(name, verbose=True), SOURCES))
        print(f"built {', '.join(str(lib.relative_to(ROOT)) for lib in libs)}"
              f" in {time.perf_counter() - t0:.1f} s", flush=True)
        recs = kernel_phase(torch, kern, ref)
        recs.update(sign_kernel_phase(torch, kern, ref))
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
