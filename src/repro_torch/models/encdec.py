"""Encoder-decoder backbone (SeamlessM4T family; PyTorch counterpart of
``repro.models.encdec``).

The modality frontend is a stub: the encoder consumes precomputed frame
embeddings (batch, frames, d_model), see :mod:`repro_torch.models.frontends`.
Decoder = standard blocks + per-layer cross-attention over encoder memory.

The params tree is the reference's, leaf for leaf: ``embed``,
``final_norm``, ``enc_norm``, ``lm_head``, and ``enc_units`` and
``dec_units``, each one dict of tensors stacked over its layers, so the
reference's params carry over through ``params_from_numpy``.  Where the
reference runs ``lax.scan`` over layers, a Python loop indexes the stacks.

Kernel routing is the reference's: under ``cfg.use_kernels`` the decoder's
causal self-attention launches flash attention; the encoder's
bidirectional self-attention (an explicit all-true mask) and the
cross-attention (precomputed k, v) run the plain path.  As in
:class:`repro_torch.models.transformer.DecoderLM`, ``decode_step`` writes
the new token's k/v into the cache in place and ``cache["pos"]`` is a
Python int.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.remat import checkpoint
from repro_torch.models.transformer import (_stack, _stack_draws, _tree_map,
                                            _unit, block_apply,
                                            block_cache_init, block_decode,
                                            block_init, block_prefill,
                                            positions_of, token_ce)

Params = Dict[str, Any]


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.num_encoder_layers <= 0:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                             "num_encoder_layers > 0")
        self.cfg = cfg

    # ---- init -----------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: DeviceLike = "cuda") -> Params:
        """Random params drawn from ``generator`` (on its device), placed
        on ``device``; JAX's draw is not reproduced (carry the reference's
        params over with ``params_from_numpy``)."""
        dev = resolve_device(device)
        cfg = self.cfg
        gen = generator
        params: Params = {
            "embed": L.normal(gen, (cfg.vocab_size, cfg.d_model), 0.02).to(
                L.torch_dtype(cfg.param_dtype)),
            "final_norm": L.norm_init(cfg.d_model, cfg, gen.device),
            "enc_norm": L.norm_init(cfg.d_model, cfg, gen.device),
            "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                    cfg.param_dtype),
        }
        params["enc_units"] = _stack_draws(
            cfg.num_encoder_layers,
            lambda _: block_init(gen, "global", cfg))
        params["dec_units"] = _stack_draws(
            cfg.num_layers, lambda _: block_init(gen, "global", cfg,
                                                 cross=True))
        return _tree_map(lambda t: t.to(dev), params)

    def _embed(self, params, tokens):
        return params["embed"][tokens].to(L.torch_dtype(self.cfg.dtype))

    def _logits(self, params, x):
        x = L.apply_norm(params["final_norm"], x, self.cfg)
        return x @ params["lm_head"].to(x.dtype)

    # ---- encoder ----------------------------------------------------------
    def encode(self, params: Params, enc_inputs: torch.Tensor) -> torch.Tensor:
        """enc_inputs: (B, F, D) stub frame embeddings -> memory (B, F, D)."""
        cfg = self.cfg
        b, f, _ = enc_inputs.shape
        x = enc_inputs.to(L.torch_dtype(cfg.dtype))
        positions = positions_of(b, f, x.device)
        full = torch.ones((f, f), dtype=torch.bool, device=x.device)
        for i in range(cfg.num_encoder_layers):
            x, _ = block_apply(_unit(params["enc_units"], i), x, "global",
                               cfg, positions=positions, self_mask=full)
        return L.apply_norm(params["enc_norm"], x, cfg)

    # ---- training ----------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor,
                enc_inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S), enc_inputs (B,F,D) -> (logits (B,S,V), 0).
        Under ``cfg.remat`` each decoder layer's body (its cross k/v
        included) is rematerialized, as the reference's
        ``jax.checkpoint(body)``."""
        cfg = self.cfg
        memory = self.encode(params, enc_inputs)
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = positions_of(b, s, x.device)

        def body(p, x, memory, positions):
            kv = L.attention_kv(p["xattn"], memory, cfg, use_rope=False)
            return block_apply(p, x, "global", cfg, positions=positions,
                               enc_kv=kv)[0]

        for i in range(cfg.num_layers):
            p = _unit(params["dec_units"], i)
            x = checkpoint(body, p, x, memory, positions) if cfg.remat \
                else body(p, x, memory, positions)
        return self._logits(params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        logits, aux = self.forward(params, batch["tokens"],
                                   batch["enc_inputs"])
        ce = token_ce(logits, batch)
        return ce, {"ce": ce, "moe_aux": aux}

    # ---- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   enc_len: int = 0, device: DeviceLike = "cuda") -> Params:
        cfg = self.cfg
        dtype = dtype or L.torch_dtype(cfg.dtype)
        dev = resolve_device(device)
        n = cfg.num_layers
        units = _stack([block_cache_init("global", cfg, batch, max_len,
                                         dtype, dev) for _ in range(n)])
        enc_len = enc_len or max_len // cfg.encoder_frames_ratio
        xshape = (n, batch, enc_len, cfg.num_kv_heads, cfg.d_head)
        units = {**units, "xk": torch.zeros(xshape, dtype=dtype, device=dev),
                 "xv": torch.zeros(xshape, dtype=dtype, device=dev)}
        return {"units": units, "pos": 0}

    def prefill(self, params: Params, tokens: torch.Tensor, max_len: int, *,
                enc_inputs: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """Full-sequence forward that fills the caches, the encoder's k/v
        of every layer included. Returns (last logits, cache)."""
        cfg = self.cfg
        memory = self.encode(params, enc_inputs)
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = positions_of(b, s, x.device)
        caches = []
        for i in range(cfg.num_layers):
            p = _unit(params["dec_units"], i)
            xk, xv = L.attention_kv(p["xattn"], memory, cfg, use_rope=False)
            x, c = block_prefill(p, x, "global", cfg, positions=positions,
                                 max_len=max_len, enc_kv=(xk, xv))
            caches.append({**c, "xk": xk, "xv": xv})
        logits = self._logits(params, x[:, -1:, :])[:, 0]
        return logits, {"units": _stack(caches), "pos": s}

    def decode_step(self, params: Params, cache: Params,
                    token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """token (B,) -> (logits (B,V), cache); the cache's k/v are updated
        in place and come back with ``pos`` advanced."""
        cfg = self.cfg
        x = self._embed(params, token[:, None])
        pos = int(cache["pos"])
        for i in range(cfg.num_layers):
            c = _unit(cache["units"], i)
            x, _ = block_decode(_unit(params["dec_units"], i), x, "global",
                                cfg, cache={"k": c["k"], "v": c["v"]},
                                pos=pos, enc_kv=(c["xk"], c["xv"]))
        logits = self._logits(params, x)[:, 0]
        return logits, {"units": cache["units"], "pos": pos + 1}
