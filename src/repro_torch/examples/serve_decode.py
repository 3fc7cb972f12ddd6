"""Serving: batched prefill and decode against every cache type (full KV
and sliding-window ring, SSM state, RG-LRU state, enc-dec cross-KV); the
twin of the JAX package's ``examples/serve_decode.py``, at its sizes.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

Each model runs with ``use_kernels`` set, so on the card the attention
archs' full-sequence attention goes through the ``flash_attention``
kernel (the port's routing: the encoder and the cross-attention stay
plain, and a prefill never launches the SSM scans); on the CPU the
wrappers take their plain versions.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.frontends import synth_audio_frames
from repro_torch.serving import DecodeEngine

# one arch per cache type, the reference's order
ARCHS = ("gemma3-12b", "mamba2-130m", "recurrentgemma-2b",
         "seamless-m4t-large-v2")
PROMPT = (2, 12)
GEN_LEN = 8
FRAMES = 4            # an encoder-decoder's stub audio frames a request


def main(device: DeviceLike = "cuda", params: Optional[Dict] = None,
         prompts: Optional[Dict] = None, frames: Optional[Dict] = None,
         archs=ARCHS) -> Dict[str, list]:
    """Greedy-decode ``GEN_LEN`` tokens of a ``PROMPT`` batch for each of
    ``archs`` and print the first sequence's tokens.  ``params``,
    ``prompts`` and ``frames`` map an arch to the reference's draws as
    numpy (its ``model.init``, prompt and ``synth_audio_frames`` from
    ``PRNGKey(0)``); an arch without them draws its own from
    ``torch.Generator().manual_seed(0)``.  Returns each arch's tokens
    (B, GEN_LEN) as lists."""
    dev = resolve_device(device)
    params, prompts, frames = params or {}, prompts or {}, frames or {}
    out = {}
    for arch in archs:
        cfg = reduced(get_config(arch), use_kernels=True)
        model = build_model(cfg)
        gen = torch.Generator().manual_seed(0)
        p = params_from_numpy(params[arch], dev) if arch in params \
            else model.init(gen, device=dev)
        engine = DecodeEngine(model, p, temperature=0.0, device=dev)
        prompt = torch.tensor(prompts[arch]) if arch in prompts \
            else torch.randint(0, cfg.vocab_size, PROMPT, generator=gen)
        kw = {}
        if cfg.family == "encdec":
            kw["enc_inputs"] = torch.tensor(frames[arch]) \
                if arch in frames \
                else synth_audio_frames(gen, cfg, PROMPT[0], FRAMES)
        res = engine.generate(prompt.to(dev), GEN_LEN, **kw)
        print(f"{arch:24s} [{cfg.family}] tokens: {res.tokens[0].tolist()}")
        out[arch] = res.tokens.tolist()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
