"""Batched serving launcher: init a model, prefill a batch of prompts,
decode N tokens, report tokens/s (PyTorch counterpart of
``repro.launch.serve``, with the same flags and defaults).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --reduced --batch 4 --prompt-len 32 --gen 16

It runs on the CUDA card.  The kernels (flash attention, the SSD and
RG-LRU scans) run only where the config sets ``use_kernels`` (a config
field that the caller sets, as ``use_pallas`` is in the reference); this
launcher keeps the registry's default, the plain path.  Its default
architecture is the reference's, mamba2-130m.  An encoder-decoder
(seamless-m4t-large-v2) gets ``prompt_len // encoder_frames_ratio`` stub
audio frames a request, drawn from the run's generator.  ``--ckpt-dir``
restores the params from the latest checkpoint there onto the model's
template, as the reference does.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import restore
from repro_torch.configs import get_config, reduced
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.models.frontends import synth_audio_frames
from repro_torch.serving import DecodeEngine


def main(argv=None, device: DeviceLike = "cuda"):
    """Parse ``argv`` and serve on ``device`` (``"cpu"`` for tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default="",
                    help="restore {\"params\": ...} from the latest "
                         "checkpoint there (repro_torch.checkpoint; the "
                         "reference's files too)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, device=dev)
    if args.ckpt_dir:
        _, tree = restore(args.ckpt_dir, {"params": params})
        params = tree["params"]

    eng = DecodeEngine(model, params, temperature=args.temperature,
                       device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    kw = {}
    if cfg.family == "encdec":
        kw["enc_inputs"] = synth_audio_frames(
            gen, cfg, args.batch,
            max(1, args.prompt_len // cfg.encoder_frames_ratio))
    t0 = time.perf_counter()
    res = eng.generate(prompt, args.gen, generator=gen, **kw)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}: {args.batch * args.gen / dt:.1f} tok/s "
          f"({dt:.2f}s total)")
    print("sample:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
