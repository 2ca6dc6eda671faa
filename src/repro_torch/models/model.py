"""The model families in torch: init / forward / prefill / decode.

Counterpart of ``repro.models.model`` for every architecture of the
registry, with the reference's general layer plan: each layer is one
sequence mixer (attention, Mamba-2, mLSTM or sLSTM) and one FFN (dense,
top-k MoE or none), with gemma2's sandwich norms and local/global
attention where the config asks for them.  Families:

* ``lm`` — decoder-only;
* ``vlm`` (phi-3-vision) — ``batch["vision"]`` patch embeddings, projected
  by ``vision_proj``, are prepended to the token stream; the prefix holds
  cache positions ``[0, vision_tokens)`` and the text follows it;
* ``encdec`` (whisper) — ``batch["audio"]`` frames run through the
  ``encoder`` (non-causal attention layers), each decoder layer is
  followed by a ``cross`` block against the encoder's K/V, which the
  cache carries as ``enc_kv``; a sinusoid gives the positions.

The parameters are ``nn.Module``s whose parameter names follow the
reference pytree (``embed``, ``final_norm.scale``, ``layers.3.attn.wq``,
``layers.1.moe.router``, ``layers.0.mamba.A_log``, ``vision_proj``,
``encoder.layers.0.ffn.wi``, ``cross.2.attn.wq``, ...) and keep its layout
and dtypes, so :func:`params_from_jax` carries reference weights over as
plain copies.

The decode path updates attention K/V caches in place (the reference
returns a new cache; here the old one is dead after the step, so writing
into it saves a copy of the whole cache per step).  SSM states are small
and come back as new tensors, as in the reference.

Training: :func:`loss_fn` is the reference's (float32 cross entropy with
z-loss 1e-4, plus 0.01 x the MoE balance loss); ``batch["segment_ids"]``
packs several documents into a row (a vlm's vision prefix joins the
first segment).  Under autograd, ``cfg.remat`` recomputes each layer (or
each scanned period) in the backward pass (``torch.utils.checkpoint``,
non-reentrant); ``remat_policy="dots"`` keeps the matmul outputs, as the
reference's ``checkpoint_dots`` does.  :func:`opt_state_from_jax` carries
a reference optimizer state over, and :func:`by_ref_path` keys grads or
moments by the reference's pytree paths.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig
from ..device import DeviceLike, default_device
from ..obs.timeline import current as current_trace
from ..obs.timeline import span
from ..runtime.actshard import constrain as act_constrain
from . import attention as attn_mod
from . import ffn as ffn_mod
from . import ssm as ssm_mod
from .common import (
    _param,
    apply_norm,
    cross_entropy,
    dtype_of,
    embed_init,
    init_norm,
    keystr,
    path_parts,
    softcap,
)

#: sequence mixers other than attention: (init, full-sequence form, one-step form)
_SSM_KINDS = {
    "mamba": (ssm_mod.init_mamba, ssm_mod.mamba_forward, ssm_mod.mamba_decode),
    "mlstm": (ssm_mod.init_mlstm, ssm_mod.mlstm_forward, ssm_mod.mlstm_decode),
    "slstm": (ssm_mod.init_slstm, ssm_mod.slstm_forward, ssm_mod.slstm_decode),
}
#: the timeline span of each sequence mixer (``obs.timeline``: host time,
#: and a ``hgum.model.*`` range in a profiler's trace)
_MIXER_SPAN = {"attn": "model.attention", **{k: f"model.{k}" for k in _SSM_KINDS}}


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, str]]:
    return list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))


def plan_period(cfg: ModelConfig) -> int:
    """Smallest period p (dividing n_layers) such that the layer plan — and
    the local/global attention alternation — repeats with period p."""
    plan = [(s, f, cfg.attn_is_local(i)) for i, (s, f) in enumerate(layer_plan(cfg))]
    n = len(plan)
    for p in range(1, n + 1):
        if n % p == 0 and all(plan[i] == plan[i % p] for i in range(n)):
            return p
    return n


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Layer(torch.nn.Module):
    """One layer: ``ln1``, the sequence mixer under its kind's name
    (``attn``, ``mamba``, ``mlstm`` or ``slstm``), ``ln1_post`` (sandwich
    norm), then, unless the FFN kind is ``none``, ``ln2``, ``ffn`` or ``moe``
    and ``ln2_post``."""

    def __init__(self, cfg: ModelConfig, seq_kind: str, ffn_kind: str, dtype,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.ln1 = init_norm(cfg.norm, cfg.d_model, dtype, device)
        if seq_kind == "attn":
            self.attn = attn_mod.init_attn(cfg, dtype, generator, device)
        elif seq_kind in _SSM_KINDS:
            setattr(self, seq_kind, _SSM_KINDS[seq_kind][0](cfg, dtype, generator, device))
        else:
            raise ValueError(seq_kind)
        if cfg.sandwich_norm:
            self.ln1_post = init_norm(cfg.norm, cfg.d_model, dtype, device)
        if ffn_kind == "none":
            return
        self.ln2 = init_norm(cfg.norm, cfg.d_model, dtype, device)
        if ffn_kind == "dense":
            self.ffn = ffn_mod.init_dense_ffn(cfg, dtype, generator, device)
        elif ffn_kind == "moe":
            self.moe = ffn_mod.init_moe_ffn(cfg, dtype, generator, device)
        else:
            raise ValueError(ffn_kind)
        if cfg.sandwich_norm:
            self.ln2_post = init_norm(cfg.norm, cfg.d_model, dtype, device)


class Encoder(torch.nn.Module):
    """whisper's encoder: ``layers`` (attention + dense FFN each) and
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, dtype, generator: torch.Generator, device=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            init_layer(cfg, "attn", "dense", dtype, generator, device)
            for _ in range(cfg.enc_layers)
        )
        self.final_norm = init_norm(cfg.norm, cfg.d_model, dtype, device)


class CrossBlock(torch.nn.Module):
    """The cross block after a decoder layer: ``ln`` and ``attn``."""

    def __init__(self, cfg: ModelConfig, dtype, generator: torch.Generator, device=None):
        super().__init__()
        self.ln = init_norm(cfg.norm, cfg.d_model, dtype, device)
        self.attn = attn_mod.init_cross_attn(cfg, dtype, generator, device)


class LM(torch.nn.Module):
    """Model parameters: ``embed`` (padded_vocab, d), ``layers``,
    ``final_norm``, and ``lm_head`` (d, padded_vocab) when not tied; a vlm
    adds ``vision_proj`` (vision_dim, d), an encdec ``encoder`` and one
    ``cross`` block per decoder layer."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device=None):
        super().__init__()
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
        if cfg.family == "vlm":
            self.vision_proj = _param(embed_init((cfg.vision_dim, cfg.d_model), generator,
                                                 dtype=dtype, device=device))
        if cfg.family == "encdec":
            self.encoder = Encoder(cfg, dtype, generator, device)
            self.cross = torch.nn.ModuleList(
                CrossBlock(cfg, dtype, generator, device) for _ in range(cfg.n_layers)
            )


def init_layer(cfg: ModelConfig, seq_kind: str, ffn_kind: str, dtype,
               generator: torch.Generator, device=None) -> Layer:
    return Layer(cfg, seq_kind, ffn_kind, dtype, generator, device)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> LM:
    """Random parameters on ``device`` (default: the CUDA card, raising
    without one).  ``generator`` must live on that device (on ``meta``, a
    CPU generator: shapes and dtypes only, nothing allocated); by default a
    fresh one seeded with 0."""
    dev = default_device(device)
    if generator is None:
        generator = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(0)
    with torch.no_grad():
        return LM(cfg, generator, dev)


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> LM:
    """The reference ``init_params`` pytree, exported as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's module state.
    Every parameter keeps its own dtype, which must be the reference's."""
    dev = default_device(device)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(_from_ref(_ref_leaf(np_tree, name), name, p.shape, p.dtype))
    return model


def _ref_leaf(np_tree, name: str):
    """The leaf of a reference pytree at a port parameter name."""
    node = np_tree
    for part in path_parts(name):
        node = node[part]
    return node


def _from_ref(node, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
    """A reference float leaf (numpy) as a CPU tensor of ``dtype`` (bfloat16
    through float32, exactly), its shape and dtype checked."""
    ref = np.asarray(node)
    if ref.shape != tuple(shape) or str(ref.dtype) != str(dtype)[len("torch."):]:
        raise ValueError(f"{name}: reference {ref.dtype}{ref.shape} != "
                         f"{dtype}{tuple(shape)}")
    return torch.from_numpy(ref.astype(np.float32)).to(dtype)


def opt_state_from_jax(np_state, params: "LM"):
    """A reference ``OptState`` (fp32 or q8 moments), exported as numpy
    arrays (``jax.tree.map(np.asarray, state)``), as the port's
    ``optim.OptState`` keyed by ``params``' parameter names, on their
    device; float32 leaves stay float32, q8's ``{'q', 's'}`` stay int8
    and float32, and its bf16 ``nu`` stays bf16."""
    from ..optim import OptState

    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device

    def moments(tree, dtype):
        return {n: _from_ref(_ref_leaf(tree, n), n, p.shape, dtype).to(dev)
                for n, p in named.items()}

    nu_dtype = torch.float32
    mu = {}
    for n, p in named.items():
        leaf = _ref_leaf(np_state.mu, n)
        if isinstance(leaf, dict):  # q8: int8 blocks and float32 scales
            nu_dtype = torch.bfloat16
            mu[n] = {k: torch.from_numpy(np.asarray(leaf[k]).copy()).to(dev)
                     for k in ("q", "s")}
        else:
            mu[n] = _from_ref(leaf, n, p.shape, torch.float32).to(dev)
    step = torch.tensor(int(np.asarray(np_state.step)), dtype=torch.int32, device=dev)
    return OptState(step=step, mu=mu, nu=moments(np_state.nu, nu_dtype),
                    master=moments(np_state.master, torch.float32))


def by_ref_path(named: Dict[str, Any]) -> Dict[str, Any]:
    """A dict keyed by the port's parameter names (grads, moments) keyed
    by the reference pytree's paths (``jax.tree_util.keystr``:
    ``layers.0.attn.wq`` -> ``['layers'][0]['attn']['wq']``), in the
    reference's flatten order."""
    items = sorted(named.items(), key=lambda kv: path_parts(kv[0]))
    return {keystr(path_parts(n)): v for n, v in items}


def param_count(params: LM) -> int:
    return sum(p.numel() for p in params.parameters())


def stack_layers(layers, period: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """[L0..Ln] -> {"pos j": {parameter name: stacked over periods}}, the
    reference's scan-over-layers layout (its pytree flattened to the port's
    dotted parameter names)."""
    out = {}
    for j in range(period):
        group = [dict(layers[i].named_parameters()) for i in range(j, len(layers), period)]
        out[f"pos{j}"] = {name: torch.stack([g[name] for g in group]) for name in group[0]}
    return out


# ---------------------------------------------------------------------------
# Per-layer forward
# ---------------------------------------------------------------------------


def layer_forward(
    p: Layer,
    x: torch.Tensor,
    cfg: ModelConfig,
    layer_idx: int,
    seq_kind: str,
    ffn_kind: str,
    *,
    mode: str,  # "full" | "decode"
    cache: Optional[Dict] = None,
    pos: Optional[torch.Tensor] = None,  # (B,) decode positions
    positions: Optional[torch.Tensor] = None,  # (B,S) full-seq positions
    segment_ids: Optional[torch.Tensor] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, Dict, Dict]:
    """Returns (x, new_cache, aux); ``aux`` holds the MoE FFN's
    ``moe_balance_loss`` and ``moe_dropped``, and is empty otherwise.
    ``segment_ids`` reach the attention mixer only, as in the reference.
    Under an open ``obs.timeline`` span each sublayer (norm, mixer or FFN,
    residual add) is a ``model.*`` span of its own."""
    aux: Dict = {}
    trace = current_trace()
    with span(trace, _MIXER_SPAN.get(seq_kind, "model.mixer")):
        h = apply_norm(cfg.norm, p.ln1, x, cfg.norm_eps)
        window = cfg.window if cfg.attn_is_local(layer_idx) else None
        if seq_kind == "attn":
            if mode == "decode":
                out, new_cache = attn_mod.attn_decode(p.attn, h, cfg, cache, pos,
                                                      window=window)
            else:
                out, (k, v) = attn_mod.attn_forward(p.attn, h, cfg, window=window,
                                                    positions=positions,
                                                    segment_ids=segment_ids,
                                                    q_offset=q_offset)
                new_cache = {"k": k, "v": v}
        elif seq_kind in _SSM_KINDS:
            _, full_fn, decode_fn = _SSM_KINDS[seq_kind]
            fn = decode_fn if mode == "decode" else full_fn
            out, new_cache = fn(getattr(p, seq_kind), h, cfg, cache)
        else:
            raise ValueError(seq_kind)
        if cfg.sandwich_norm:
            out = apply_norm(cfg.norm, p.ln1_post, out, cfg.norm_eps)
        x = x + out

    if ffn_kind != "none":
        with span(trace, "model.ffn" if ffn_kind == "dense" else "model.moe"):
            h = apply_norm(cfg.norm, p.ln2, x, cfg.norm_eps)
            if ffn_kind == "dense":
                out = ffn_mod.dense_ffn(p.ffn, h, cfg)
            else:
                out, aux = ffn_mod.moe_ffn(p.moe, h, cfg)
            if cfg.sandwich_norm:
                out = apply_norm(cfg.norm, p.ln2_post, out, cfg.norm_eps)
            x = x + out
    return x, new_cache, aux


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
    logits = act_constrain(x @ head, "logits")
    if cfg.padded_vocab != cfg.vocab:  # mask the pad rows (see padded_vocab)
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=x.device), logits)
    return softcap(logits.float(), cfg.final_softcap)


def _front_end(params: LM, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """Token (+ vision prefix) embedding.  Returns (x, n_prefix_positions)."""
    x = _embed_tokens(params, cfg, batch["tokens"])
    if cfg.family == "vlm" and "vision" in batch:
        vis = batch["vision"].to(x.dtype) @ params.vision_proj
        return torch.cat([vis, x], dim=1), vis.shape[1]
    return x, 0


def _sinusoidal(S: int, d: int, offset=0, device=None) -> torch.Tensor:
    """The reference's float32 position table, sin and cos halves
    concatenated: (1, S, d), or (B, S, d) for a (B,) tensor ``offset``
    (decode's per-example positions)."""
    off = torch.as_tensor(offset, device=device).to(torch.float32).reshape(-1, 1, 1)
    pos = off + torch.arange(S, dtype=torch.float32, device=off.device)[None, :, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=off.device)
    ang = pos / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------


def encode(params: LM, cfg: ModelConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio: (B, enc_seq, d_model) — precomputed conv-frontend embeddings."""
    dtype = dtype_of(cfg.dtype)
    x = audio.to(dtype) + _sinusoidal(audio.shape[1], cfg.d_model,
                                      device=audio.device).to(dtype)
    enc = params.encoder
    for lp in enc.layers:
        h = apply_norm(cfg.norm, lp.ln1, x, cfg.norm_eps)
        out, _ = attn_mod.attn_forward(lp.attn, h, cfg, causal=False)
        x = x + out
        h = apply_norm(cfg.norm, lp.ln2, x, cfg.norm_eps)
        x = x + ffn_mod.dense_ffn(lp.ffn, h, cfg)
    return apply_norm(cfg.norm, enc.final_norm, x, cfg.norm_eps)


def _cross_block(params: LM, cfg: ModelConfig, i: int, x: torch.Tensor,
                 enc_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    cp = params.cross[i]
    h = apply_norm(cfg.norm, cp.ln, x, cfg.norm_eps)
    return x + attn_mod.cross_attn_forward(cp.attn, h, enc_kv, cfg)


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
) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    """Returns (logits, cache | None, aux).  ``batch["tokens"]``: (B,S).

    ``aux`` sums each MoE layer's ``moe_balance_loss`` and ``moe_dropped``
    over ``n_layers`` (a mean over all layers, dense ones counting zero).
    ``last_only`` computes logits for the final position only (serving
    prefill needs just the next token).  A vlm's ``batch["vision"]`` (B,
    vision_tokens, vision_dim) prefix takes positions ``[0, n_prefix)``,
    the text's ``positions`` shift up by ``n_prefix``, and the prefix rows
    get no logits and join the text's first segment; an encdec reads
    ``batch["audio"]`` (B, enc_seq, d).  Under autograd, ``cfg.remat``
    recomputes each layer (with its cross block) in the backward pass."""
    x, n_prefix = _front_end(params, cfg, batch)
    B, S, _ = x.shape
    positions = batch.get("positions")
    segment_ids = batch.get("segment_ids")
    if segment_ids is not None and n_prefix:
        pre = segment_ids[:, :1].expand(B, n_prefix)
        segment_ids = torch.cat([pre, segment_ids], dim=1)
    if positions is not None and n_prefix:
        pre = torch.arange(n_prefix, dtype=positions.dtype, device=positions.device)
        positions = torch.cat([pre.expand(B, n_prefix), positions + n_prefix], dim=1)
    if not cfg.use_rope and cfg.family == "encdec":
        x = x + _sinusoidal(S, cfg.d_model, device=x.device).to(x.dtype)
    enc_kv = None
    if cfg.family == "encdec":
        enc_out = encode(params, cfg, batch["audio"])
        enc_kv = [attn_mod.cross_kv(cp.attn, enc_out, cfg) for cp in params.cross]
    aux_acc: Dict[str, torch.Tensor] = {}
    caches: List[Dict] = []
    x = act_constrain(x, "residual")

    def run_layer(x, i, lp, s, f):
        x, kv, aux = layer_forward(lp, x, cfg, i, s, f, mode="full",
                                   positions=positions, segment_ids=segment_ids)
        if enc_kv is not None:
            x = _cross_block(params, cfg, i, x, enc_kv[i])
        return act_constrain(x, "residual"), kv, aux

    if cfg.scan_layers and not want_cache and cfg.family == "lm":
        x, aux_acc = _forward_scanned(params, cfg, x, positions, segment_ids)
    else:
        run = _remat(cfg, run_layer)
        for i, (lp, (s, f)) in enumerate(zip(params.layers, layer_plan(cfg))):
            x, kv, aux = run(x, i, lp, s, f)
            for k, v in aux.items():
                aux_acc[k] = aux_acc.get(k, 0.0) + v / cfg.n_layers
            if want_cache:
                caches.append(kv)
    with span(current_trace(), "model.head"):
        x = apply_norm(cfg.norm, params.final_norm, x, cfg.norm_eps)
        if n_prefix:
            x = x[:, n_prefix:]
        if last_only:
            x = x[:, -1:]
        logits = _unembed(params, cfg, x)
    cache = None
    if want_cache:
        # the vision prefix holds cache positions too: S counts it
        want_len = cache_len + n_prefix if cache_len is not None else S
        cache = _grow_cache(cfg, caches, B, S, want_len, x.device, enc_kv)
    return logits, cache, aux_acc


def _forward_scanned(params: LM, cfg: ModelConfig, x, positions, segment_ids):
    """The reference's scan over layer periods: each period's layers run
    with their position in the period as ``layer_idx`` (the plan and the
    local/global alternation repeat with the period, so it is the same
    layer).  Eager torch traces nothing, so the periods are a loop over
    the unstacked layers; ``aux`` is the reference's: the last period
    position's ``moe_balance_loss`` (zero where that layer is dense),
    averaged over periods."""
    p = plan_period(cfg)
    plan = layer_plan(cfg)

    def period(x, k):
        for j in range(p):
            s, f = plan[j]
            x, _, aux = layer_forward(params.layers[k * p + j], x, cfg, j, s, f, mode="full",
                                      positions=positions, segment_ids=segment_ids)
            x = act_constrain(x, "residual")
        return x, aux.get("moe_balance_loss", torch.zeros((), device=x.device))

    run = _remat(cfg, period)  # the reference remats the scanned body
    bal = []
    for k in range(cfg.n_layers // p):
        x, b = run(x, k)
        bal.append(b)
    return x, {"moe_balance_loss": torch.stack(bal).mean()}


#: the ops whose outputs ``remat_policy="dots"`` keeps (``checkpoint_dots``)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` as the reference's ``jax.checkpoint(fn, policy=_remat_policy(cfg))``
    where ``cfg.remat`` is set and autograd records (remat changes what the
    backward pass keeps, never a value): "nothing" keeps only ``fn``'s
    inputs, "dots" also the matmul outputs."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _kv_len(cfg: ModelConfig, layer: int, seq_len: int, cache_len: int) -> int:
    """K/V rows the prefill of a ``seq_len`` prompt keeps in ``layer``:
    ``cache_len`` slots (the prompt's, if longer) in a global layer; in a
    sliding-window layer the last ``min(cache_len, window)`` keys, a ring,
    which stays aligned with ``pos % window`` only where the window divides
    the prompt."""
    if cfg.window is None or not cfg.attn_is_local(layer):
        return max(seq_len, cache_len)
    want = min(cache_len, cfg.window)
    if seq_len > want and seq_len % want:
        raise ValueError(f"SWA ring alignment needs window|seq, got {want} vs {seq_len}")
    return want


def _grow_cache(cfg: ModelConfig, caches: List[Dict], batch: int, total: int,
                cache_len: int, device, enc_kv=None) -> Dict:
    """Pad prefill KV to ``cache_len`` slots (decode appends in place); a
    sliding-window layer keeps only its last ``window`` keys (see
    :func:`_kv_len`).  SSM states pass through.  ``total`` counts the
    positions consumed, a vision prefix included; an encdec's ``enc_kv``
    (one (k, v) of (B, enc_seq, n_kv, hd) per layer) rides along."""
    out_layers = []
    for i, ((s, _), kv) in enumerate(zip(layer_plan(cfg), caches)):
        if s != "attn":
            out_layers.append(kv)
            continue
        k, v = kv["k"], kv["v"]
        want = _kv_len(cfg, i, k.shape[1], cache_len)
        if k.shape[1] > want:
            k, v = k[:, -want:], v[:, -want:]
        elif want > k.shape[1]:
            pad = (0, 0, 0, 0, 0, want - k.shape[1])
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        out_layers.append({"k": k.contiguous(), "v": v.contiguous()})
    cache = {
        "layers": out_layers,
        "pos": torch.full((batch,), total, dtype=torch.int32, device=device),
    }
    if enc_kv is not None:
        cache["enc_kv"] = enc_kv
    return cache


# ---------------------------------------------------------------------------
# Cache init / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None) -> Dict:
    """An empty cache of ``cache_len`` positions (an encdec's ``enc_kv``
    zeros too)."""
    dev = default_device(device)
    dtype = dtype_of(cfg.dtype)
    layers = []
    for i, (s, _) in enumerate(layer_plan(cfg)):
        if s == "attn":
            T = cache_len
            if cfg.window is not None and cfg.attn_is_local(i):
                T = min(T, cfg.window)
            shape = (batch, T, cfg.n_kv, cfg.hd)
            layers.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
        elif s == "mamba":
            layers.append(ssm_mod.mamba_init_state(cfg, batch, dtype, dev))
        elif s == "mlstm":
            layers.append(ssm_mod.mlstm_init_state(cfg, batch, dev))
        else:
            layers.append(ssm_mod.slstm_init_state(cfg, batch, device=dev))
    cache = {"layers": layers, "pos": torch.zeros(batch, dtype=torch.int32, device=dev)}
    if cfg.family == "encdec":
        shape = (batch, cfg.enc_seq, cfg.n_kv, cfg.hd)
        cache["enc_kv"] = [(torch.zeros(shape, dtype=dtype, device=dev),
                            torch.zeros(shape, dtype=dtype, device=dev))
                           for _ in range(cfg.n_layers)]
    return cache


def cache_zeros(cfg: ModelConfig, batch: int, seq_len: int, cache_len: int,
                device: DeviceLike = None) -> Dict:
    """Zeros of the shapes and dtypes of the cache that ``prefill`` returns
    for ``batch`` prompts of ``seq_len`` tokens and ``cache_len``: the
    reference's scheduler allocates its slot cache so (from prefill's
    ``jax.eval_shape``).  Unlike :func:`init_cache`, the mLSTM and sLSTM
    stabilisers ``m`` are 0 here, not -1e30.  The batch is the one the
    scheduler feeds: a vlm's carries the vision prefix, which adds
    ``vision_tokens`` rows to every K/V, and an encdec's cache has
    ``enc_kv``.  Raises ``ValueError`` where prefill would (a window that
    does not divide a longer prompt)."""
    cache = init_cache(cfg, batch, cache_len, device)
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    for i, layer in enumerate(cache["layers"]):
        for name, t in layer.items():
            shape = tuple(t.shape)
            if name in ("k", "v"):
                rows = _kv_len(cfg, i, seq_len + n_prefix, cache_len + n_prefix)
                shape = (batch, rows) + shape[2:]
            layer[name] = torch.zeros(shape, dtype=t.dtype, device=t.device)
    return cache


def decode_step(
    params: LM, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor
) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B,1).  Returns (logits (B,1,V), cache);
    the cache's K/V tensors are updated in place, and an encdec's
    ``enc_kv`` comes back as it was."""
    pos = cache["pos"]
    x = _embed_tokens(params, cfg, tokens)
    if not cfg.use_rope and cfg.family == "encdec":
        # each example's sinusoid at its own offset
        x = x + _sinusoidal(1, cfg.d_model, offset=pos).to(x.dtype)
    new_layers = []
    for i, (lp, (s, f)) in enumerate(zip(params.layers, layer_plan(cfg))):
        x, kv, _ = layer_forward(lp, x, cfg, i, s, f, mode="decode",
                                 cache=cache["layers"][i], pos=pos)
        if cfg.family == "encdec":
            x = _cross_block(params, cfg, i, x, cache["enc_kv"][i])
        new_layers.append(kv)
    with span(current_trace(), "model.head"):
        x = apply_norm(cfg.norm, params.final_norm, x, cfg.norm_eps)
        logits = _unembed(params, cfg, x)
    new_cache = dict(cache)
    new_cache["layers"] = new_layers
    new_cache["pos"] = pos + 1
    return logits, new_cache


def prefill(
    params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
    cache_len: Optional[int] = None, last_only: bool = False,
) -> Tuple[torch.Tensor, Dict]:
    logits, cache, _ = forward(params, cfg, batch, want_cache=True, cache_len=cache_len,
                               last_only=last_only)
    return logits, cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_fn(params: LM, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """The reference's training loss: masked cross entropy over
    ``batch["labels"]`` and ``batch["loss_mask"]`` with z-loss 1e-4, plus
    0.01 x ``moe_balance_loss`` for an MoE model.  Returns (loss, metrics)."""
    logits, _, aux = forward(params, cfg, batch)
    loss, metrics = cross_entropy(logits, batch["labels"], batch.get("loss_mask"), z_loss=1e-4)
    if "moe_balance_loss" in aux:
        loss = loss + 0.01 * aux["moe_balance_loss"]
        metrics["moe_balance_loss"] = aux["moe_balance_loss"]
    metrics["loss"] = loss
    return loss, metrics
