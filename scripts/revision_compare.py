#!/usr/bin/env python3
"""Hold the tree's LM kernels against another revision of the repo on one
CUDA card, kernel and end to end, in turns.

    git archive <commit> | tar -x -C build/other
    python3 scripts/revision_compare.py --other build/other [--what attention]

``--other`` is a checkout of the other revision (unpacked where
``.gitignore`` lists it, such as ``build/``).  Every turn (other, tree,
tree, other) is a child process that imports the port from one tree's
``src/`` and builds that tree's kernels from its own sources into its own
``build/kernels/``, so the two need not share a C signature or a wrapper.
The shapes, the inputs (from fixed seeds) and the timers are the tree's
``chip_smoke.py``'s, so both see the same data.  ``--what``:

- ``attention``: ``flash_attention`` at (a), (b) and (c) of
  ``ATTN_CASES`` in float32 (inputs drawn in float32, with the device ms
  of each launch, ``stage_ms``) and in bfloat16, CUDA-event ms
  (``time_ms``); then float32 qwen2-0.5b prefill and
  recurrentgemma-2b ``loss`` and prefill at full width (8 x 1024 tokens,
  random weights from seed 0, ``use_kernels=True``);
- ``ssd_scan``: ``ssd_scan`` at ``SSD_CASES`` in float32 and bfloat16,
  ``SSD_TIMED`` with the device ms of each launch (``stage_ms``); then
  mamba2-130m ``loss`` at full width in both types.

A model run is the median of REPS calls after a warm-up call at the same
shape (host clock after ``synchronize``).  The parent prints the card's
name and power limit first, every turn's numbers, whether each output of
the two trees' first turns is equal bit for bit (and their max |diff|),
and one JSON line last.  The turns share one call because the host-bound
parts of the model runs move by up to 1.7x between calls.
"""
import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 3
TURNS = ("other", "tree", "tree", "other")
MODEL_RUNS = {
    "attention": (("qwen2-0.5b", "float32", "prefill"),
                  ("recurrentgemma-2b", "float32", "loss"),
                  ("recurrentgemma-2b", "float32", "prefill")),
    "ssd_scan": (("mamba2-130m", "float32", "loss"),
                 ("mamba2-130m", "bfloat16", "loss")),
}


def kernel_runs(torch, cs, what):
    """(label, call, staged) of every kernel call to time and compare;
    ``staged``: also time each of its launches."""
    if what == "attention":
        from repro_torch.kernels import attention as kattn
        gen = torch.Generator(device="cuda").manual_seed(3)
        for at in cs.ATTN_CASES[:3]:
            for dtype in ("float32", "bfloat16"):
                case = at[:6] + (dtype,) + at[7:9]
                q, k, v = cs.attention_inputs(torch, gen, case)
                yield f"flash_attention {case}", (
                    lambda q=q, k=k, v=v, c=case: kattn.flash_attention(
                        q, k, v, causal=c[7], window=c[8])), \
                    dtype == "float32"
    else:
        from repro_torch.kernels import ssd_scan as kssd
        gen = torch.Generator(device="cuda").manual_seed(11)
        for case in cs.SSD_CASES:
            for dtype in ("float32", "bfloat16"):
                ins = cs.ssd_inputs(torch, gen, *case[:5], dtype)
                yield f"ssd_scan {case} {dtype}", (
                    lambda ins=ins, c=case: kssd.ssd_scan(
                        *ins, chunk=c[5])), case == cs.SSD_TIMED


def model_runs(torch, cs, what):
    """(label, call) of every model run to time and compare."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    for arch, dtype, name in MODEL_RUNS[what]:
        cfg = dataclasses.replace(get_config(arch), use_kernels=True,
                                  dtype=dtype, param_dtype=dtype)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = model.init(gen, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (cs.SSM_BATCH,
                                                 cs.SSM_SEQ + 1),
                             generator=gen, device="cuda")
        if name == "prefill":
            def call():
                return model.prefill(params, toks[:, :-1], cs.SSM_SEQ + 1)[0]
        else:
            def call():
                return model.loss(params, {"tokens": toks[:, :-1],
                                           "targets": toks[:, 1:]})[0]
        yield f"{arch} {dtype} {name}", call
        del model, params, toks, call
        torch.cuda.empty_cache()


def child(tree: Path, what: str, out: Path) -> None:
    """One turn: this tree's port, the outputs and times saved to ``out``."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"ms": {}, "stages_ms": {}, "s": {}, "outputs": {}}
    for label, call, staged in kernel_runs(torch, cs, what):
        res["outputs"][label] = call().cpu()
        res["ms"][label] = cs.time_ms(torch, call, 5)
        if staged:
            res["stages_ms"][label] = cs.stage_ms(torch, call)
        print(f"  {label}: {res['ms'][label]:.5f} ms", flush=True)
    with torch.inference_mode():
        for label, call in model_runs(torch, cs, what):
            call()                                   # warm-up, full shape
            torch.cuda.synchronize()
            secs = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                y = call()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            res["s"][label] = statistics.median(secs)
            res["outputs"][label] = y.float().cpu()
            print(f"  {label}: {res['s'][label]:.5f} s (median of {REPS})",
                  flush=True)
    torch.save(res, out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--what", choices=sorted(MODEL_RUNS),
                    default="attention")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.what, args.out)
        return 0
    import torch
    if not torch.cuda.is_available() or args.other is None:
        print("revision_compare: needs a CUDA card and --other",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    trees = {"tree": ROOT, "other": args.other.resolve()}
    work = ROOT / "build" / "compare"
    work.mkdir(parents=True, exist_ok=True)
    turns = []
    for n, who in enumerate(TURNS):
        out = work / f"{args.what}_{n}_{who}.pt"
        print(f"turn {n}: {who} ({trees[who]})", flush=True)
        subprocess.run([sys.executable, __file__, "--child",
                        str(trees[who]), "--what", args.what, "--out",
                        str(out)], check=True)
        turns.append((who, torch.load(out)))
    first = {who: res for who, res in reversed(turns)}
    report = {"other": str(args.other), "what": args.what, "turns": [
        {"who": who, **{k: res[k] for k in ("ms", "stages_ms", "s")}}
        for who, res in turns], "outputs": {}}
    for label, y in first["tree"]["outputs"].items():
        yo = first["other"]["outputs"][label]
        cmp = {"equal": bool(torch.equal(y, yo)),
               "max_abs_diff": float((y.float() - yo.float()).abs().max())}
        report["outputs"][label] = cmp
        print(f"{label}: tree vs other {cmp}", flush=True)
    print(json.dumps({"revision_compare": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
