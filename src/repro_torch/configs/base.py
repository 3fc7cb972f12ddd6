"""Unified model configuration for every assigned architecture family
(a copy of ``repro.configs.base``, the JAX package's).

One dataclass covers dense / moe / ssm / hybrid / audio (enc-dec) / vlm.
Fields irrelevant to a family keep their defaults; ``family`` selects the
forward-pass builder in ``repro_torch.models.model``.  One difference
from the reference: ``use_pallas`` is ``use_kernels`` here (same role,
same default).  ``act_pspec`` is the residual stream's placement on a
DTensor's mesh (``repro_torch.models.transformer.constrain_acts``), where
the reference's is a GSPMD sharding constraint.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""       # citation for the exact numbers

    # trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None     # SWA width when a layer is 'local'
    # per-pattern-unit layer kinds, tiled over depth.  entries:
    #   'global' (full attn) | 'local' (SWA) | 'rglru' (RG-LRU block) | 'ssd' (Mamba-2)
    block_pattern: Tuple[str, ...] = ("global",)
    attn_logit_softcap: Optional[float] = None

    # mlp
    mlp_variant: str = "swiglu"  # swiglu | relu2 | geglu | gelu | none
    tie_embeddings: bool = False

    # moe
    num_experts: int = 0         # 0 => dense mlp
    num_experts_per_tok: int = 0
    moe_d_ff: Optional[int] = None  # expert hidden size (olmoe: 1024); default d_ff
    router_aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25

    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64

    # rglru (recurrentgemma)
    rglru_width: Optional[int] = None   # recurrence width; default d_model
    conv1d_width: int = 4

    # enc-dec (seamless)
    num_encoder_layers: int = 0
    encoder_frames_ratio: int = 4   # encoder length = seq_len // ratio (stub frontend)

    # norm / dtypes
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"         # activations/compute
    param_dtype: str = "bfloat16"   # stored params

    # runtime knobs (not architecture): set by launchers
    remat: bool = False
    use_kernels: bool = False       # route attention/ssd/rglru through the CUDA kernels
    attn_chunk_q: int = 512         # q-block for the memory-bounded jnp path
    moe_group: int = 2048           # GShard token-group size
    # 'einsum' = classic GShard one-hot dispatch (O(T*E*C*d) flops/bytes);
    # 'gather' = index-based dispatch (O(E*C*d) bytes, no dispatch matmul) —
    # §Perf iteration, numerically identical (tested)
    moe_dispatch: str = "einsum"
    # optional activation sharding constraint on the residual stream
    # (PartitionSpec entries for (batch, seq, d_model)), applied inside the
    # layer loop; None entries = unconstrained.  Used by §Perf iterations.
    act_pspec: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.num_experts and self.moe_d_ff is None:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.rglru_width is None:
            object.__setattr__(self, "rglru_width", self.d_model)

    # ---- derived quantities -------------------------------------------------
    @property
    def num_pattern_units(self) -> int:
        """Full pattern repetitions (scanned); remainder layers are unrolled."""
        return self.num_layers // len(self.block_pattern)

    @property
    def pattern_remainder(self) -> Tuple[str, ...]:
        """Trailing layers when depth is not a multiple of the pattern
        (e.g. recurrentgemma-2b: 26 layers, unit (rglru, rglru, local))."""
        r = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:r]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return self.block_pattern * self.num_pattern_units + self.pattern_remainder

    @property
    def d_head(self) -> int:
        return self.head_dim  # type: ignore[return-value]

    @property
    def is_subquadratic(self) -> bool:
        """True when the arch can serve ~500k context (SWA / SSM / RG-LRU)."""
        kinds = set(self.block_pattern)
        if kinds <= {"local", "rglru", "ssd"}:
            return True
        # mixed local/global (gemma3) still bounds *most* layers; we accept
        # patterns that contain any sub-quadratic kind AND use a sliding window
        # for their 'local' layers, following the task's carve-out.
        return ("local" in kinds or "ssd" in kinds or "rglru" in kinds)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS; exactness
        is tested against actual pytrees for the reduced variants)."""
        d, L = self.d_model, self.num_layers
        total = self.vocab_size * d          # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d     # lm head
        total += d                            # final norm
        for kind in self.layer_kinds:
            per = 0
            if kind in ("global", "local"):
                hq = self.num_heads * self.d_head
                hk = self.num_kv_heads * self.d_head
                per += d * hq + 2 * d * hk + hq * d          # q,k,v,o
                if self.qkv_bias:
                    per += hq + 2 * hk
                per += d                                      # pre-attn norm
            elif kind == "ssd":
                di = self.ssm_expand * d
                nh = di // self.ssm_head_dim
                conv_dim = di + 2 * self.ssm_state
                per += d * (2 * di + 2 * self.ssm_state + nh)  # in_proj
                per += conv_dim * self.ssm_conv_width          # conv
                per += 2 * nh                                  # A_log, D
                per += nh                                      # dt_bias
                per += di                                      # out norm
                per += di * d                                  # out_proj
                per += d                                       # pre norm
            elif kind == "rglru":
                w = self.rglru_width
                per += d * w * 2 + w * d                       # in_x, in_gate, out
                per += w * self.conv1d_width + w               # conv1d
                per += 2 * w * w + w                           # w_a, w_i, Lambda
                per += d                                       # pre norm
            # mlp part (attention blocks and Griffin recurrent blocks have MLPs)
            if kind in ("global", "local", "rglru"):
                if self.num_experts:
                    e_ff = self.moe_d_ff
                    n_mats = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
                    per += self.num_experts * n_mats * d * e_ff
                    per += d * self.num_experts                # router
                elif self.mlp_variant != "none":
                    n_mats = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
                    per += n_mats * d * self.d_ff
                per += d                                       # pre-mlp norm
            total += per
        if self.num_encoder_layers:
            # encoder layers: full attn + mlp, same widths
            hq = self.num_heads * self.d_head
            hk = self.num_kv_heads * self.d_head
            enc = d * hq + 2 * d * hk + hq * d + 2 * d
            n_mats = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
            enc += n_mats * d * self.d_ff
            # decoder cross-attention (one per decoder layer) accounted here
            cross = d * hq + 2 * d * hk + hq * d + d
            total += enc * self.num_encoder_layers + cross * L
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        n_mats = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        per_expert = n_mats * d * self.moe_d_ff
        inactive = (self.num_experts - self.num_experts_per_tok) * per_expert
        return int(self.param_count() - inactive * self.num_layers)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=2 layers, d<=512,
    <=4 experts), preserving every structural trait of the full config."""
    pat = cfg.block_pattern
    if len(pat) > 3:  # compress e.g. gemma3's (local*5, global) -> (local, global)
        pat = tuple(dict.fromkeys(pat))
    d_model = min(cfg.d_model, 128)
    n_heads = min(cfg.num_heads, 4)
    n_kv = max(1, min(cfg.num_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    changes = dict(
        block_pattern=pat,
        num_layers=max(2, len(pat)),
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else None,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2) if cfg.num_experts else 0,
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.num_experts else None,
        # no-drop capacity in smoke variants so prefill/decode/forward agree
        capacity_factor=(min(cfg.num_experts, 4) / max(1, min(cfg.num_experts_per_tok, 2)))
        if cfg.num_experts else cfg.capacity_factor,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=8 if cfg.ssm_state else cfg.ssm_chunk,
        rglru_width=d_model,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        dtype="float32",
        param_dtype="float32",
        name=cfg.name + "-smoke",
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
