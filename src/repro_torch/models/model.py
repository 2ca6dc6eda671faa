"""The ``lm`` model family in torch: init / forward / prefill / decode.

Counterpart of ``repro.models.model`` for decoder-only models whose layers
are all attention + dense FFN (yi-6b, stablelm, granite, ...).  The
parameters are ``nn.Module``s whose parameter names follow the reference
pytree (``embed``, ``final_norm.scale``, ``layers.3.attn.wq``, ...) and keep
its layout, so :func:`params_from_jax` carries reference weights over as
plain copies.  Other families (vlm, encdec) and layer kinds (MoE, mamba,
mLSTM, sLSTM) raise ``NotImplementedError``.

The decode path updates the KV cache in place (the reference returns a new
cache; here the old one is dead after the step, so writing into it saves a
copy of the whole cache per step).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, default_device
from . import attention as attn_mod
from . import ffn as ffn_mod
from .common import _param, apply_norm, dtype_of, embed_init, init_norm, softcap

_TODO = "ROADMAP.md queue A item 12 (other model families)"


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, str]]:
    return list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "lm":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: {_TODO}")
    for s, f in layer_plan(cfg):
        if s != "attn" or f != "dense":
            raise NotImplementedError(
                f"layer kind ({s}, {f}) is not ported yet: {_TODO}"
            )
    if cfg.sandwich_norm or cfg.window is not None:
        raise NotImplementedError(f"gemma2 sandwich norms / windows are not ported yet: {_TODO}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Layer(torch.nn.Module):
    """One attention + dense-FFN layer: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, dtype, generator: torch.Generator, device=None):
        super().__init__()
        self.ln1 = init_norm(cfg.norm, cfg.d_model, dtype, device)
        self.attn = attn_mod.init_attn(cfg, dtype, generator, device)
        self.ln2 = init_norm(cfg.norm, cfg.d_model, dtype, device)
        self.ffn = ffn_mod.init_dense_ffn(cfg, dtype, generator, device)


class LM(torch.nn.Module):
    """Decoder-only LM parameters: ``embed`` (padded_vocab, d), ``layers``,
    ``final_norm``, and ``lm_head`` (d, padded_vocab) when not tied."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device=None):
        super().__init__()
        _check_supported(cfg)
        dtype = dtype_of(cfg.dtype)
        self.embed = _param(embed_init((cfg.padded_vocab, cfg.d_model), generator,
                                       dtype=dtype, device=device))
        self.final_norm = init_norm(cfg.norm, cfg.d_model, dtype, device)
        self.layers = torch.nn.ModuleList(
            init_layer(cfg, s, f, dtype, generator, device) for s, f in layer_plan(cfg)
        )
        if not cfg.tie_embeddings:
            self.lm_head = _param(embed_init((cfg.d_model, cfg.padded_vocab), generator,
                                             dtype=dtype, device=device))
        else:
            self.lm_head = None


def init_layer(cfg: ModelConfig, seq_kind: str, ffn_kind: str, dtype,
               generator: torch.Generator, device=None) -> Layer:
    if seq_kind != "attn" or ffn_kind != "dense":
        raise NotImplementedError(f"layer kind ({seq_kind}, {ffn_kind}) is not ported yet: {_TODO}")
    return Layer(cfg, dtype, generator, device)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> LM:
    """Random parameters on ``device`` (default: the CUDA card, raising
    without one).  ``generator`` must live on that device; by default a
    fresh one seeded with 0."""
    dev = default_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        return LM(cfg, generator, dev)


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> LM:
    """The reference ``init_params`` pytree, exported as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's module state."""
    dev = default_device(device)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    names = dict(model.named_parameters())
    want = set(names)
    with torch.no_grad():
        for name, p in names.items():
            node = np_tree
            for part in name.split("."):
                node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
            arr = np.array(node, np.float32)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr).to(p.dtype))
            want.discard(name)
    if want:  # pragma: no cover - every name was visited above
        raise ValueError(f"parameters not carried over: {sorted(want)}")
    return model


def param_count(params: LM) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# Per-layer forward
# ---------------------------------------------------------------------------


def layer_forward(
    p: Layer,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,  # "full" | "decode"
    cache: Optional[Dict] = None,
    pos: Optional[torch.Tensor] = None,  # (B,) decode positions
    positions: Optional[torch.Tensor] = None,  # (B,S) full-seq positions
) -> Tuple[torch.Tensor, Dict]:
    """Returns (x, new_cache)."""
    h = apply_norm(cfg.norm, p.ln1, x, cfg.norm_eps)
    if mode == "decode":
        out, kv = attn_mod.attn_decode(p.attn, h, cfg, cache, pos)
    else:
        out, (k, v) = attn_mod.attn_forward(p.attn, h, cfg, positions=positions)
        kv = {"k": k, "v": v}
    x = x + out
    h = apply_norm(cfg.norm, p.ln2, x, cfg.norm_eps)
    x = x + ffn_mod.dense_ffn(p.ffn, h, cfg)
    return x, kv


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def _embed_tokens(params: LM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params.embed[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    return x


def _unembed(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params.lm_head if params.lm_head is not None else params.embed.T
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab:  # mask the pad rows (see padded_vocab)
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=x.device), logits)
    return softcap(logits.float(), cfg.final_softcap)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill body)
# ---------------------------------------------------------------------------


def forward(
    params: LM,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    *,
    want_cache: bool = False,
    cache_len: Optional[int] = None,
    last_only: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (logits, cache | None).  ``batch["tokens"]``: (B,S).

    ``last_only`` computes logits for the final position only (serving
    prefill needs just the next token)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    positions = batch.get("positions")
    caches: List[Dict] = []
    for lp in params.layers:
        x, kv = layer_forward(lp, x, cfg, mode="full", positions=positions)
        if want_cache:
            caches.append(kv)
    x = apply_norm(cfg.norm, params.final_norm, x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = _unembed(params, cfg, x)
    cache = None
    if want_cache:
        total = tokens.shape[1]
        want_len = cache_len if cache_len is not None else total
        cache = _grow_cache(cfg, caches, tokens.shape[0], total, want_len)
    return logits, cache


def _grow_cache(cfg: ModelConfig, caches: List[Dict], batch: int, total: int,
                cache_len: int) -> Dict:
    """Pad prefill KV to ``cache_len`` slots (decode appends in place)."""
    out_layers = []
    for kv in caches:
        k, v = kv["k"], kv["v"]
        if cache_len > k.shape[1]:
            pad = (0, 0, 0, 0, 0, cache_len - k.shape[1])
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        out_layers.append({"k": k.contiguous(), "v": v.contiguous()})
    return {
        "layers": out_layers,
        "pos": torch.full((batch,), total, dtype=torch.int32, device=k.device),
    }


# ---------------------------------------------------------------------------
# Cache init / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None) -> Dict:
    _check_supported(cfg)
    dev = default_device(device)
    dtype = dtype_of(cfg.dtype)
    shape = (batch, cache_len, cfg.n_kv, cfg.hd)
    layers = [
        {"k": torch.zeros(shape, dtype=dtype, device=dev),
         "v": torch.zeros(shape, dtype=dtype, device=dev)}
        for _ in range(cfg.n_layers)
    ]
    return {"layers": layers, "pos": torch.zeros(batch, dtype=torch.int32, device=dev)}


def decode_step(
    params: LM, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor
) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B,1).  Returns (logits (B,1,V), cache);
    the cache's K/V tensors are updated in place."""
    pos = cache["pos"]
    x = _embed_tokens(params, cfg, tokens)
    new_layers = []
    for i, lp in enumerate(params.layers):
        x, kv = layer_forward(lp, x, cfg, mode="decode", cache=cache["layers"][i], pos=pos)
        new_layers.append(kv)
    x = apply_norm(cfg.norm, params.final_norm, x, cfg.norm_eps)
    logits = _unembed(params, cfg, x)
    return logits, {"layers": new_layers, "pos": pos + 1}


def prefill(
    params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
    cache_len: Optional[int] = None, last_only: bool = False,
) -> Tuple[torch.Tensor, Dict]:
    logits, cache = forward(params, cfg, batch, want_cache=True, cache_len=cache_len,
                            last_only=last_only)
    return logits, cache
