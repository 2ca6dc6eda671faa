"""Model / run configuration system.

One frozen dataclass describes an architecture; ``configs/<id>.py``
instantiates it with the exact published numbers.  ``registry`` maps
``--arch`` ids to configs; ``smoke_config`` shrinks any config to a
CPU-runnable variant of the same family for tests.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "lm" | "encdec" | "vlm"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # --- attention flavour ---
    window: Optional[int] = None  # sliding-window size for local layers
    local_global_alternate: bool = False  # gemma2: alternate local/global
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    use_rope: bool = True

    # --- ffn flavour ---
    act: str = "swiglu"  # swiglu | geglu | gelu

    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 2
    moe_every: int = 1  # MoE FFN on layers where (layer % moe_every == moe_offset)
    moe_offset: int = 0
    moe_dff: Optional[int] = None  # expert hidden dim (default d_ff)
    capacity_factor: float = 1.25

    # --- layer pattern (hybrid models) ---
    layer_pattern: str = "attn"  # "attn" | "jamba" (attn every 8th) | "xlstm"

    # --- SSM (mamba / xlstm) dims ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head: int = 64  # SSD head dim

    # --- encoder-decoder ---
    enc_layers: int = 0
    enc_seq: int = 1500  # whisper frame count after conv stub
    enc_dim: Optional[int] = None

    # --- VLM ---
    vision_tokens: int = 0
    vision_dim: int = 0

    # --- misc ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    embed_scale: bool = False  # multiply embeddings by sqrt(d) (gemma)
    sandwich_norm: bool = False  # post-sublayer norms (gemma2)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # --- runtime knobs (perf-iteration surface) ---
    scan_layers: bool = False  # scan over layers (smaller HLO, fuzzier costs)
    remat: bool = True
    microbatch: int = 1  # gradient-accumulation steps per train_step
    opt_moments: str = "fp32"  # "q8": int8/bf16 Adam moments (398B-class)
    remat_policy: str = "nothing"  # "nothing" | "dots" (save dot outputs)
    attn_p_bf16: bool = False  # cast softmax weights to bf16 for the PV dot

    # --- provenance ---
    source: str = ""
    verified: str = "unverified"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab rounded up to 128 so the vocab dim
        shards over any mesh axis (whisper's 51865 is otherwise prime-ish
        and forces replicated fp32 logits).  Pad logits are masked to -inf
        at the unembed."""
        return -(-self.vocab // 128) * 128

    # ---- layer plans ------------------------------------------------------

    def layer_kinds(self) -> Tuple[str, ...]:
        """Sequence kind per layer: attn | mamba | mlstm | slstm."""
        if self.layer_pattern == "attn":
            return ("attn",) * self.n_layers
        if self.layer_pattern == "jamba":
            # paper: Jamba block = 8 layers, 1 attention : 7 mamba
            return tuple(
                "attn" if (i % 8) == 4 else "mamba" for i in range(self.n_layers)
            )
        if self.layer_pattern == "xlstm":
            # alternate mLSTM / sLSTM blocks
            return tuple(
                "mlstm" if (i % 2) == 0 else "slstm" for i in range(self.n_layers)
            )
        raise ValueError(f"unknown layer_pattern {self.layer_pattern!r}")

    def ffn_kinds(self) -> Tuple[str, ...]:
        """FFN kind per layer: dense | moe | none."""
        if self.d_ff == 0:
            return ("none",) * self.n_layers
        if self.moe_experts > 0:
            return tuple(
                "moe" if (i % self.moe_every) == self.moe_offset else "dense"
                for i in range(self.n_layers)
            )
        return ("dense",) * self.n_layers

    def attn_is_local(self, layer: int) -> bool:
        if self.window is None:
            return False
        if self.local_global_alternate:
            return layer % 2 == 0  # gemma2: even layers local
        return True  # uniform sliding window (mistral/mixtral style)

    # ---- parameter count (for 6ND model-flops accounting) -----------------

    def param_counts(self) -> Dict[str, float]:
        d, hd = self.d_model, self.hd
        nq, nkv = self.n_heads, self.n_kv
        counts = {"embed": self.vocab * d}
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        dense_ffn = glu * d * self.d_ff
        moe_dff = self.moe_dff or self.d_ff
        moe_ffn = self.moe_experts * glu * d * moe_dff + d * self.moe_experts
        d_in = self.ssm_expand * d
        mamba = (
            2 * d * d_in  # in/out proj (x and gate)
            + d_in * self.ssm_conv
            + d_in * (2 * self.ssm_state + d_in // self.ssm_head)  # B,C,dt heads
            + d_in
        )
        # q,k,v + output gate (d->d_in each) + out_proj + i/f gate heads
        mlstm = 5 * d * d_in + 2 * d * self.n_heads + 3 * d_in
        slstm = 4 * d * d + 4 * d  # i,f,z,o projections
        total = counts["embed"] * (1 if self.tie_embeddings else 2)
        active = total
        for kind, fk in zip(self.layer_kinds(), self.ffn_kinds()):
            seq_p = {"attn": attn, "mamba": mamba, "mlstm": mlstm, "slstm": slstm}[kind]
            total += seq_p
            active += seq_p
            if fk == "dense":
                total += dense_ffn
                active += dense_ffn
            elif fk == "moe":
                total += moe_ffn
                active += d * self.moe_experts + self.moe_topk * glu * d * moe_dff
        if self.family == "encdec":
            enc = self.enc_layers * (attn + dense_ffn)
            cross = self.n_layers * attn
            total += enc + cross
            active += enc + cross
        if self.family == "vlm":
            total += self.vision_dim * d
            active += self.vision_dim * d
        counts["total"] = float(total)
        counts["active"] = float(active)
        return counts


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set) and registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_loaded() -> None:
    # import the per-arch modules exactly once (they call register()).
    from . import (  # noqa: F401
        gemma2_27b,
        granite_34b,
        yi_6b,
        stablelm_3b,
        whisper_tiny,
        jamba_1_5_large,
        mixtral_8x22b,
        phi35_moe,
        phi3_vision,
        xlstm_125m,
    )


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs — long_500k needs sub-quadratic
    attention (see DESIGN.md §5)."""
    if shape.name == "long_500k":
        subq = cfg.layer_pattern in ("jamba", "xlstm") or (
            cfg.window is not None and not cfg.local_global_alternate
        )
        if not subq:
            return False, "full attention is not sub-quadratic at 500k (DESIGN.md §5)"
    if cfg.family == "encdec" and shape.name == "long_500k":
        return False, "enc-dec: 500k decoder context out of scope (DESIGN.md §5)"
    return True, ""


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return replace(
        cfg,
        n_layers=min(cfg.n_layers, 4 if cfg.layer_pattern == "attn" else 8),
        d_model=128,
        n_heads=4,
        n_kv=min(cfg.n_kv, 4) if cfg.n_kv > 1 else 1,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        moe_dff=None,
        vocab=512,
        moe_experts=min(cfg.moe_experts, 4),
        window=min(cfg.window, 64) if cfg.window else None,
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=min(cfg.enc_seq, 32),
        vision_tokens=min(cfg.vision_tokens, 16),
        vision_dim=min(cfg.vision_dim, 64) if cfg.vision_dim else 0,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head=32,
        dtype="float32",
        microbatch=1,
    )
