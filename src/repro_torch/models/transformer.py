"""Decoder-only LM for the dense, local-attention, MoE, SSM (Mamba-2 SSD)
and hybrid (Griffin RG-LRU + local attention) families, and the blocks
the encoder-decoder backbone (:mod:`repro_torch.models.encdec`) is built
from (PyTorch counterpart of ``repro.models.transformer``).

Layers are grouped into *pattern units* (``cfg.block_pattern``) that repeat
``cfg.num_pattern_units`` times.  The params tree is the reference's, leaf
for leaf: ``embed``, ``final_norm``, optional ``lm_head``, ``units`` (a
tuple with one dict per pattern kind, every tensor stacked on a leading
unit axis) and ``rem`` (the depth remainder's blocks, e.g.
recurrentgemma-2b's 2 trailing RG-LRU blocks).  Where the reference runs
``lax.scan`` over units, a Python loop here indexes the stacked tensors,
so JAX params carry over through :func:`params_from_numpy` unchanged.

Three entry points per model:
  * ``loss``        — training forward + mean token CE (+ MoE aux)
  * ``prefill``     — full-sequence forward that also fills decode caches
  * ``decode_step`` — one-token step against the caches

Kernel routing is the reference's: under ``cfg.use_kernels`` the
full-sequence forward (``forward``, ``loss``) launches flash attention on
every attention layer, ``ssd_scan`` on every SSD layer and ``rglru_scan``
on every RG-LRU layer.  ``prefill`` launches flash attention only: its SSD
and RG-LRU layers run the model's default paths, which also give the final
state the cache needs (the reference's ``block_prefill`` calls
``ssd_scan_ref`` and ``rglru_core`` without the kernel), and decode is a
one-step recurrence.  An MoE block's experts are plain matmuls on every
path: capacity dispatch in ``forward``, ``loss`` and ``prefill``, every
expert weighted by its gate in ``decode_step``, as in the reference.

Caches differ from the reference in two ways: ``decode_step`` writes the
new token's k/v, SSM state, RG-LRU state and conv buffer into the cache
tensors in place (the reference builds new arrays), so a cache passed to
it must not be used again; and the position ``cache["pos"]`` is a Python
int, so indexing the cache never waits for the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (DeviceLike, dtensor_layout, redistribute,
                                resolve_device)
from repro_torch.models import layers as L
from repro_torch.models.remat import checkpoint

Params = Dict[str, Any]

_ATTN_KINDS = ("global", "local")


def constrain_acts(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Optional residual-stream sharding constraint (cfg.act_pspec), a §Perf
    knob: pins the layout the residual keeps between layers.  A DTensor
    residual is redistributed to ``act_pspec``'s placements on its own
    mesh, where the reference asks GSPMD for a sharding constraint, and
    its gradient goes back to the residual's placements, inside the
    training step's ``vmap``/``grad`` too (:func:`repro_torch.device.
    redistribute`).  An axis ``act_pspec`` names that the residual's mesh
    lacks is left out: in the training step that is a worker axis, which
    the process's row already is.  A plain tensor, or ``act_pspec`` None,
    comes back unchanged (the reference's no-mesh case)."""
    if cfg.act_pspec is None:
        return x
    layout = dtensor_layout(x)
    if layout is None:
        return x
    d = layout[0]
    from repro_torch.launch.partitioning import placements
    names = set(d.device_mesh.mesh_dim_names)
    spec = tuple(_axes_in(e, names) for e in cfg.act_pspec)
    return redistribute(x, placements(spec, d.device_mesh))


def _axes_in(entry, names):
    """A spec entry with only the mesh axes in ``names`` (None if none)."""
    if isinstance(entry, tuple):
        kept = tuple(a for a in entry if a in names)
        return kept if len(kept) > 1 else (kept[0] if kept else None)
    return entry if entry in names else None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack(trees):
    """Dicts of equal structure -> one dict of tensors stacked on axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _stack_draws(n: int, draw):
    """``draw(u)`` for u in range(n), each a dict of tensors of one
    structure, stacked on a new axis 0 as they come: the peak is the stack
    plus one draw, not twice the stack (a full-width MoE's experts)."""
    out = None
    for u in range(n):
        tree = draw(u)
        if out is None:
            out = _tree_map(lambda t: t.new_empty((n,) + t.shape), tree)
        _copy_into(out, tree, u)
    return out


def _copy_into(stack, tree, u: int) -> None:
    if isinstance(stack, dict):
        for k in stack:
            _copy_into(stack[k], tree[k], u)
    else:
        stack[u].copy_(tree)


def _unit(tree, u: int):
    """The u-th unit's view of a unit-stacked tree (no copy)."""
    return _tree_map(lambda t: t[u], tree)


# --------------------------------------------------------------------------
# block init / apply
# --------------------------------------------------------------------------
def block_init(gen: torch.Generator, kind: str, cfg: ModelConfig,
               cross: bool = False) -> Params:
    p: Params = {"ln1": L.norm_init(cfg.d_model, cfg, gen.device)}
    if kind in _ATTN_KINDS:
        p["attn"] = L.attention_init(gen, cfg)
    elif kind == "ssd":
        p["ssd"] = L.ssd_init(gen, cfg)
    elif kind == "rglru":
        p["rglru"] = L.rglru_init(gen, cfg)
    else:
        raise ValueError(kind)
    if cross:
        p["lnx"] = L.norm_init(cfg.d_model, cfg, gen.device)
        p["xattn"] = L.attention_init(gen, cfg)
    if cfg.mlp_variant != "none" and cfg.d_ff > 0 and kind != "ssd":
        p["ln2"] = L.norm_init(cfg.d_model, cfg, gen.device)
        if cfg.num_experts:
            p["moe"] = L.moe_init(gen, cfg)
        else:
            p["mlp"] = L.mlp_init(gen, cfg)
    return p


def _mixer_window(kind: str, cfg: ModelConfig) -> Optional[int]:
    return cfg.sliding_window if kind == "local" else None


def _cross_residual(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, enc_kv) -> torch.Tensor:
    """x plus the cross-attention over the encoder's (k, v), where the
    block has one: every query sees every frame, no RoPE (the plain path,
    as the mask is explicit)."""
    if "xattn" not in p:
        return x
    if enc_kv is None:
        raise ValueError("a cross-attention block needs enc_kv")
    h = L.apply_norm(p["lnx"], x, cfg)
    full = torch.ones((h.shape[-2], enc_kv[0].shape[-3]), dtype=torch.bool,
                      device=x.device)
    return x + L.attention_apply(p["xattn"], h, cfg, positions=positions,
                                 kv=enc_kv, mask=full, use_rope=False)


def _mlp_residual(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  decode: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x plus the block's MLP or MoE of ln2(x), and the MoE's aux loss
    (None without one, and at ``decode``, where every expert runs)."""
    if "ln2" not in p:
        return x, None
    h = L.apply_norm(p["ln2"], x, cfg)
    if "mlp" in p:
        return x + L.mlp_apply(p["mlp"], h, cfg), None
    if decode:
        return x + L.moe_apply_dense(p["moe"], h, cfg), None
    h, aux = L.moe_apply(p["moe"], h, cfg)
    return x + h, aux


def block_apply(p: Params, x: torch.Tensor, kind: str, cfg: ModelConfig, *,
                positions: torch.Tensor,
                enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                self_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block. Returns (x, moe_aux); moe_aux is 0 without an
    MoE.  ``self_mask`` overrides the causal mask (the encoder's
    bidirectional one), which routes the attention to the plain path."""
    h = L.apply_norm(p["ln1"], x, cfg)
    if kind == "ssd":
        h = L.ssd_apply(p["ssd"], h, cfg)
    elif kind == "rglru":
        h = L.rglru_apply(p["rglru"], h, cfg)
    else:
        h = L.attention_apply(p["attn"], h, cfg, positions=positions,
                              window=_mixer_window(kind, cfg), mask=self_mask)
    x = _cross_residual(p, x + h, cfg, positions, enc_kv)
    x, aux = _mlp_residual(p, x, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# ---- prefill: same forward but emits decode caches -------------------------
def block_prefill(p: Params, x: torch.Tensor, kind: str, cfg: ModelConfig, *,
                  positions: torch.Tensor, max_len: int,
                  enc_kv=None) -> Tuple[torch.Tensor, Params]:
    """Returns (x_out, cache) where cache layout matches block_decode.  The
    SSD and RG-LRU blocks run their default paths (no kernel), as the
    reference's prefill does, and keep their conv buffer from the pre-conv
    inputs."""
    b, s, _ = x.shape
    h = L.apply_norm(p["ln1"], x, cfg)
    if kind == "ssd":
        h, state, xbc = L.ssd_forward(p["ssd"], h, cfg, use_kernels=False)
        cache: Params = {"ssm": state,
                         "conv": L.last_rows(xbc, cfg.ssm_conv_width - 1)}
    elif kind == "rglru":
        h, h_final, xs_pre = L.rglru_forward(p["rglru"], h, cfg,
                                             use_kernels=False)
        cache = {"h": h_final,
                 "conv": L.last_rows(xs_pre, cfg.conv1d_width - 1)}
    else:
        k, v = L.attention_kv(p["attn"], h, cfg, positions=positions)
        if kind == "global":
            kc = k.new_zeros((b, max_len) + k.shape[2:])
            vc = v.new_zeros((b, max_len) + v.shape[2:])
            kc[:, :s] = k
            vc[:, :s] = v
            cache = {"k": kc, "v": vc}
        else:
            w = cfg.sliding_window
            # slot j holds the last prompt position p with p % w == j
            idx = np.array([s - 1 - ((s - 1 - j) % w) for j in range(w)])
            valid = idx >= 0
            idx_c = torch.as_tensor(np.where(valid, idx, 0), device=x.device)
            keep = torch.as_tensor(valid, device=x.device)[None, :, None, None]
            zero = torch.zeros((), dtype=k.dtype, device=x.device)
            kc = torch.where(keep, k[:, idx_c], zero)
            vc = torch.where(keep, v[:, idx_c], zero)
            slot_pos = torch.as_tensor(np.where(valid, idx, -1),
                                       dtype=torch.int32, device=x.device)
            cache = {"k": kc, "v": vc, "slot_pos": slot_pos}
        h = L.attention_apply(p["attn"], h, cfg, positions=positions,
                              window=_mixer_window(kind, cfg))
    x = _cross_residual(p, x + h, cfg, positions, enc_kv)
    return _mlp_residual(p, x, cfg)[0], cache


def block_decode(p: Params, x: torch.Tensor, kind: str, cfg: ModelConfig, *,
                 cache: Params, pos: int,
                 enc_kv=None) -> Tuple[torch.Tensor, Params]:
    """One-token step. x: (B,1,D); pos: int (position being written).  The
    new k/v (and, for a local layer, its slot position), or the new SSM or
    RG-LRU state and conv buffer, are written into ``cache``'s tensors in
    place; the same dict comes back.  A cross-attention block reads the
    fixed encoder (k, v) of ``enc_kv``."""
    b = x.shape[0]
    h = L.apply_norm(p["ln1"], x, cfg)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if kind in ("ssd", "rglru"):
        decode = L.ssd_decode if kind == "ssd" else L.rglru_decode
        h, new = decode(p[kind], h, cfg, cache)
        for key, t in new.items():
            cache[key].copy_(t)
    else:
        k, v = L.attention_kv(p["attn"], h, cfg, positions=positions)
        if kind == "global":
            cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
            cpos = torch.arange(cache["k"].shape[1], dtype=torch.int32,
                                device=x.device)
            cache_positions = torch.where(cpos <= pos, cpos, -1)
        else:
            slot = pos % cfg.sliding_window
            cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
            cache["slot_pos"][slot] = pos
            cache_positions = cache["slot_pos"]
        h = L.attention_decode(
            p["attn"], h, cfg, k_cache=cache["k"], v_cache=cache["v"],
            cache_positions=cache_positions.expand(
                (b,) + cache_positions.shape),
            position=positions[:, 0])
    x = _cross_residual(p, x + h, cfg, positions, enc_kv)
    return _mlp_residual(p, x, cfg, decode=True)[0], cache


def block_cache_init(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype: torch.dtype, device=None) -> Params:
    if kind == "global":
        shape = (batch, max_len, cfg.num_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "local":
        w = cfg.sliding_window
        shape = (batch, w, cfg.num_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "slot_pos": torch.full((w,), -1, dtype=torch.int32,
                                       device=device)}
    if kind == "ssd":
        return L.ssd_init_state(cfg, batch, dtype, device)
    if kind == "rglru":
        return L.rglru_init_state(cfg, batch, dtype, device)
    raise ValueError(kind)


def positions_of(b: int, s: int, device) -> torch.Tensor:
    """The positions 0..s-1 of every row, (b, s) int32."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def token_ce(logits: torch.Tensor, batch: Dict[str, torch.Tensor]):
    """Mean token cross-entropy of ``batch["targets"]`` under ``logits``
    (in float32), over ``batch["mask"]`` where given."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# --------------------------------------------------------------------------
# the decoder-only LM
# --------------------------------------------------------------------------
class DecoderLM:
    """Decoder-only LM. Stateless: params/caches are explicit."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---- init ----------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: DeviceLike = "cuda") -> Params:
        """Random params drawn from ``generator`` (on the generator's
        device, so a CUDA generator draws on the card), placed on
        ``device``.  JAX's PRNG is not reproduced: to hold the port to the
        reference, carry the reference's params over with
        :func:`params_from_numpy`."""
        dev = resolve_device(device)
        cfg = self.cfg
        gen = generator
        params: Params = {
            "embed": L.normal(gen, (cfg.vocab_size, cfg.d_model), 0.02).to(
                L.torch_dtype(cfg.param_dtype)),
            "final_norm": L.norm_init(cfg.d_model, cfg, gen.device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             cfg.param_dtype)
        n_units = cfg.num_pattern_units
        # drawn unit by unit, each unit's blocks in pattern order
        units = _stack_draws(n_units, lambda u: {
            j: block_init(gen, kind, cfg)
            for j, kind in enumerate(cfg.block_pattern)})
        params["units"] = tuple(units[j] for j in
                                range(len(cfg.block_pattern))) \
            if n_units else ()
        params["rem"] = tuple(block_init(gen, kind, cfg)
                              for kind in cfg.pattern_remainder)
        return _tree_map(lambda t: t.to(dev), params)

    # ---- helpers ---------------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"][tokens].to(L.torch_dtype(self.cfg.dtype))

    def _logits(self, params, x):
        x = L.apply_norm(params["final_norm"], x, self.cfg)
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return L.dense(x, head)

    def _blocks(self, params):
        """(block params, kind, unit index or None, pattern index) in depth
        order: the units' blocks, then the remainder's."""
        cfg = self.cfg
        for u in range(cfg.num_pattern_units):
            for j, kind in enumerate(cfg.block_pattern):
                yield _unit(params["units"][j], u), kind, u, j
        for j, kind in enumerate(cfg.pattern_remainder):
            yield params["rem"][j], kind, None, j

    def _unit_edge(self, x, u: Optional[int], j: int, edge: int):
        """:func:`constrain_acts` where the reference's unit body applies
        it: before a pattern unit's first block (``edge`` 0) and after its
        last (``edge`` -1); the remainder's blocks are not constrained."""
        pattern = range(len(self.cfg.block_pattern))
        if u is None or j != pattern[edge]:
            return x
        return constrain_acts(x, self.cfg)

    def _unit_body(self, unit, x, aux, positions):
        """One pattern unit, the reference's ``unit_body``: the residual
        constrained on its way in and out, the unit's blocks in order."""
        x = constrain_acts(x, self.cfg)
        for p, kind in zip(unit, self.cfg.block_pattern):
            x, a = block_apply(p, x, kind, self.cfg, positions=positions)
            aux = aux + a
        return constrain_acts(x, self.cfg), aux

    # ---- training --------------------------------------------------------
    def forward(self, params: Params,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S) -> (logits (B,S,V), moe_aux scalar).  Under
        ``cfg.remat`` each pattern unit is rematerialized (its backward
        runs it again), as the reference's ``jax.checkpoint(unit_body)``."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = positions_of(b, s, x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for u in range(cfg.num_pattern_units):
            unit = tuple(_unit(t, u) for t in params["units"])
            if cfg.remat:
                x, aux = checkpoint(self._unit_body, unit, x, aux, positions)
            else:
                x, aux = self._unit_body(unit, x, aux, positions)
        for p, kind in zip(params["rem"], cfg.pattern_remainder):
            x, a = block_apply(p, x, kind, cfg, positions=positions)
            aux = aux + a
        return self._logits(params, x), aux

    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        logits, aux = self.forward(params, batch["tokens"])
        ce = token_ce(logits, batch)
        return ce + aux, {"ce": ce, "moe_aux": aux}

    # ---- serving ---------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device: DeviceLike = "cuda") -> Params:
        cfg = self.cfg
        dtype = dtype or L.torch_dtype(cfg.dtype)
        dev = resolve_device(device)
        n_units = cfg.num_pattern_units

        def one(kind):
            return block_cache_init(kind, cfg, batch, max_len, dtype, dev)

        units = tuple(_stack([one(kind) for _ in range(n_units)])
                      for kind in cfg.block_pattern) if n_units else ()
        rem = tuple(one(kind) for kind in cfg.pattern_remainder)
        return {"units": units, "rem": rem, "pos": 0}

    def prefill(self, params: Params, tokens: torch.Tensor,
                max_len: int) -> Tuple[torch.Tensor, Params]:
        """Full-sequence forward that fills caches. Returns (last logits, cache)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = positions_of(b, s, x.device)
        unit_caches = [[] for _ in cfg.block_pattern]
        rem_caches = []
        for p, kind, u, j in self._blocks(params):
            x = self._unit_edge(x, u, j, 0)
            x, c = block_prefill(p, x, kind, cfg, positions=positions,
                                 max_len=max_len)
            x = self._unit_edge(x, u, j, -1)
            (unit_caches[j] if u is not None else rem_caches).append(c)
        units = tuple(_stack(c) for c in unit_caches) \
            if cfg.num_pattern_units else ()
        logits = self._logits(params, x[:, -1:, :])
        return logits[:, 0], {"units": units, "rem": tuple(rem_caches),
                              "pos": s}

    def decode_step(self, params: Params, cache: Params,
                    token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """token (B,) -> (logits (B,V), cache).  The cache's tensors are
        updated in place and come back in a dict with ``pos`` advanced."""
        x = self._embed(params, token[:, None])
        pos = int(cache["pos"])
        for p, kind, u, j in self._blocks(params):
            c = _unit(cache["units"][j], u) if u is not None \
                else cache["rem"][j]
            x, _ = block_decode(p, x, kind, self.cfg, cache=c, pos=pos)
        logits = self._logits(params, x)[:, 0]
        return logits, {"units": cache["units"], "rem": cache["rem"],
                        "pos": pos + 1}


# --------------------------------------------------------------------------
# the weight carrier
# --------------------------------------------------------------------------
def params_from_numpy(tree, device: DeviceLike = "cuda"):
    """An LM's params from the JAX package (the same tree of dicts and
    tuples, with numpy leaves, e.g. from ``jax.device_get``) as the port's
    tensors on ``device``.  bfloat16 leaves (numpy dtype named
    "bfloat16") come over bit for bit through a uint16 view, as the
    reference's checkpoint does it; uint16 leaves are read as such bits."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
            bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    return _tree_map(leaf, tree)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: the same tree with numpy
    leaves on the host.  numpy has no bfloat16 of its own, so bfloat16
    leaves come back as their uint16 bit patterns (which
    :func:`params_from_numpy` reads back as bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return _tree_map(leaf, tree)
