#!/usr/bin/env python3
"""Hold the tree's ``ssd_scan`` kernel against another revision of
``csrc/ssd_scan.cu`` on one CUDA card.

    python3 scripts/ssd_scan_compare.py --other OLD.cu --abi single|passes

``--other`` is a copy of the other source (for example ``git show
<commit>:src/repro_torch/kernels/csrc/ssd_scan.cu > build/old/ssd_scan.cu``)
and ``--abi`` its C signature: ``single`` for the earlier single-CTA
kernel (one CTA per (head, batch) walking the chunks, no scratch),
``passes`` for the chunk-parallel kernel's (states, G and cum scratch,
``kernels/ssd_scan.py::ssd_plan``).  Both are built with the tree's
``nvcc`` flags.  At every case of ``chip_smoke.SSD_CASES``, in float32
and bfloat16, it prints whether the two outputs are equal bit for bit
(and how many elements differ, by how much) and each one's max |kernel -
plain| / max |plain| against ``ssd_ref``.  Then it times both at
``chip_smoke.SSD_TIMED`` in turns (other, tree, tree, other; CUDA events)
with the device time of each launch (``torch.profiler``), prints the
card's name and power limit first and one JSON line last.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--abi", required=True, choices=("single", "passes"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_scan_compare: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as kssd
    print(cs.card_line(), flush=True)
    _build.build("ssd_scan")
    out = ROOT / "build" / "compare" / f"lib_{args.other.stem}_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(args.other)], capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"nvcc failed on {args.other}:\n{proc.stderr}", file=sys.stderr)
        return 1
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = ctypes.CDLL(str(out)).hsgd_ssd_scan
    fn.argtypes = ([P] * 6 + [I32] * 7 + [I64] * 6 + [P]
                   if args.abi == "single"
                   else [P] * 9 + [I32] * 7 + [I64] * 6 + [P])
    fn.restype = ctypes.c_int

    def other(x, dt, A, B, C, chunk):
        bt, s, h, p = x.shape
        n = B.shape[-1]
        y = torch.empty((bt, s, h, p), dtype=x.dtype, device=x.device)
        (x, B, C), strides = kssd.kernel_operands(x, B, C)
        dt, A = dt.contiguous(), A.contiguous()
        scratch = []
        if args.abi == "passes":
            plan = kssd.ssd_plan(bt, s, h, p, n, chunk)
            scratch = [torch.empty(plan[k], dtype=torch.float32,
                                   device=x.device)
                       for k in ("states", "G", "cum")]
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(),
                 *(t.data_ptr() for t in scratch),
                 0 if x.dtype == torch.float32 else 1, bt, s, h, p, n,
                 chunk, *strides, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"other kernel: cudaError {err}")
        return y

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for case in cs.SSD_CASES:
        bt, s, h, p, n, chunk = case
        for dtype in ("float32", "bfloat16"):
            ins = cs.ssd_inputs(torch, gen, bt, s, h, p, n, dtype)
            y = kssd.ssd_scan(*ins, chunk=chunk)
            yo = other(*ins, chunk)
            want, _ = ref.ssd_ref(*ins)
            torch.cuda.synchronize()
            scale = float(want.float().abs().max())
            rec = {"case": list(case), "dtype": dtype,
                   "equal": bool(torch.equal(y, yo)),
                   "differ": int((y != yo).sum()),
                   "max_diff": float((y.float() - yo.float()).abs().max()),
                   "rel": float((y.float() - want.float()).abs().max())
                   / scale,
                   "other_rel": float((yo.float() - want.float()).abs().max())
                   / scale}
            cases.append(rec)
            print(f"{case} {dtype}: equal {rec['equal']} ({rec['differ']} "
                  f"differ, max {rec['max_diff']!r}); relative to plain: "
                  f"tree {rec['rel']!r}, other {rec['other_rel']!r}",
                  flush=True)
            del ins, y, yo, want
    bt, s, h, p, n, chunk = cs.SSD_TIMED
    timed = {}
    for dtype in ("float32", "bfloat16"):
        ins = cs.ssd_inputs(torch, gen, bt, s, h, p, n, dtype)
        runs = {"other": [], "tree": []}
        for who in ("other", "tree", "tree", "other"):
            call = (lambda: other(*ins, chunk)) if who == "other" else \
                (lambda: kssd.ssd_scan(*ins, chunk=chunk))
            runs[who].append(cs.time_ms(torch, call, 5))
        t = {"tree_ms": runs["tree"], "other_ms": runs["other"],
             "tree_stages_ms": cs.stage_ms(
                 torch, lambda: kssd.ssd_scan(*ins, chunk=chunk)),
             "other_stages_ms": cs.stage_ms(
                 torch, lambda: other(*ins, chunk))}
        timed[dtype] = t
        print(f"{cs.SSD_TIMED} {dtype}: tree {t['tree_ms']} ms, other "
              f"{t['other_ms']} ms; by launch: tree {t['tree_stages_ms']}, "
              f"other {t['other_stages_ms']}", flush=True)
        del ins
    print(json.dumps({"ssd_scan_compare": {"other": str(args.other),
                                           "abi": args.abi, "cases": cases,
                                           "timed": timed}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
