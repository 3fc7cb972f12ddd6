"""The paper's own experiment models, at CPU scale (PyTorch counterpart of
``repro.models.simple``).

Softmax-CE classifiers on non-IID data: an MLP (VGG stand-in), a small CNN
(FEMNIST stand-in) and a linear model.  Params are plain dicts of tensors
with the reference's keys.  Dense weights keep the reference's (din, dout)
layout; the CNN's conv weights are OIHW (``conv2d``'s layout) where the
reference keeps HWIO, and the CNN flattens its pooled maps in the
reference's NHWC order so the ``out`` weights mean the same thing in both
packages.  ``params_from_numpy`` / ``params_to_numpy`` convert between the
two layouts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SimpleConfig:
    kind: str = "mlp"          # 'mlp' | 'cnn' | 'linear'
    input_dim: int = 32        # mlp/linear: features; cnn: image side
    channels: int = 1
    hidden: int = 64
    num_classes: int = 10


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def _dense(gen, din, dout):
    return {"w": _normal(gen, (din, dout), 1.0 / math.sqrt(din)),
            "b": torch.zeros((dout,))}


class SimpleModel:
    def __init__(self, cfg: SimpleConfig):
        self.cfg = cfg

    def init(self, generator: torch.Generator,
             device: DeviceLike = "cuda") -> Dict[str, Any]:
        """Random params from ``generator`` (a CPU ``torch.Generator``, so
        one seed gives the same weights on every device), placed on
        ``device``."""
        dev = resolve_device(device)
        cfg = self.cfg
        if cfg.kind == "linear":
            p = {"out": _dense(generator, cfg.input_dim, cfg.num_classes)}
        elif cfg.kind == "mlp":
            p = {"h1": _dense(generator, cfg.input_dim, cfg.hidden),
                 "h2": _dense(generator, cfg.hidden, cfg.hidden),
                 "out": _dense(generator, cfg.hidden, cfg.num_classes)}
        else:
            # two 3x3 convs + pool + dense (the paper's FEMNIST CNN, shrunk)
            c = cfg.channels
            p = {"c1": {"w": _normal(generator, (8, c, 3, 3), 1.0 / 3.0),
                        "b": torch.zeros((8,))},
                 "c2": {"w": _normal(generator, (16, 8, 3, 3),
                                     1.0 / math.sqrt(72)),
                        "b": torch.zeros((16,))},
                 "out": _dense(generator, (cfg.input_dim // 4) ** 2 * 16,
                               cfg.num_classes)}
        return {k: {n: t.to(dev) for n, t in v.items()} for k, v in p.items()}

    def logits(self, params, x):
        cfg = self.cfg
        if cfg.kind == "linear":
            return x @ params["out"]["w"] + params["out"]["b"]
        if cfg.kind == "mlp":
            h = torch.relu(x @ params["h1"]["w"] + params["h1"]["b"])
            h = torch.relu(h @ params["h2"]["w"] + params["h2"]["b"])
            return h @ params["out"]["w"] + params["out"]["b"]
        d, c = cfg.input_dim, cfg.channels
        h = x.reshape(x.shape[0], d, d, c).permute(0, 3, 1, 2)   # NCHW
        for name in ("c1", "c2"):
            h = F.conv2d(h, params[name]["w"], padding=1) \
                + params[name]["b"][:, None, None]
            h = torch.relu(h)
            h = F.max_pool2d(h, 2, 2)
        # flatten in NHWC order, as the reference does
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return h @ params["out"]["w"] + params["out"]["b"]

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        lg = self.logits(params, batch["x"])
        logp = torch.log_softmax(lg, dim=-1)
        y = batch["y"].long()
        nll = -logp.gather(-1, y[:, None]).mean()
        return nll, {"ce": nll}

    def accuracy(self, params, batch) -> torch.Tensor:
        lg = self.logits(params, batch["x"])
        return (lg.argmax(-1) == batch["y"].long()).to(torch.float32).mean()


def params_from_numpy(tree, device: DeviceLike = "cuda"):
    """The reference's params (nested dicts of numpy arrays, e.g. from
    ``jax.device_get``) as the port's: tensors on ``device``, 4-D conv
    weights moved from HWIO to OIHW."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.tensor(a).to(dev)

    return {k: params_from_numpy(v, dev) if isinstance(v, dict) else conv(v)
            for k, v in tree.items()}


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: nested dicts of numpy arrays
    in the reference's layout (conv weights back to HWIO)."""
    def back(t):
        a = t.detach().cpu().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    return {k: params_to_numpy(v) if isinstance(v, dict) else back(v)
            for k, v in tree.items()}
