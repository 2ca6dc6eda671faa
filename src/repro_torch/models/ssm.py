"""Sequence-mixing SSM blocks: Mamba-2 (SSD), mLSTM and sLSTM (plain torch).

Counterpart of ``repro.models.ssm``.  Each block has a chunkwise form for
a whole sequence (prefill) and a one-step form on an O(1) state (decode).
The reference's ``lax.scan`` over chunks (Mamba, mLSTM) or time steps
(sLSTM) is a Python loop here, in the same order of work, and the float32
forms are kept as the reference writes them: the SSD decay is masked
*before* the ``exp`` (``s > t`` would overflow), and the mLSTM stabiliser
``m`` starts at ``-1e30``.

Parameters keep the reference's names and dtypes: Mamba's ``A_log``, ``D``
and ``dt_bias``, mLSTM's ``wif`` and ``b_if`` and every sLSTM weight and
bias are float32 in a bfloat16 model.  States are float32, except Mamba's
conv state, which has the model's dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import _param, dense_init, rmsnorm

CHUNK = 256


def _pad_to_chunks(x: torch.Tensor, axis: int = 1, chunk: int = CHUNK):
    S = x.shape[axis]
    pad = (-S) % chunk
    if pad:
        widths = [0, 0] * x.ndim  # F.pad lists the last axis first
        widths[2 * (x.ndim - 1 - axis) + 1] = pad
        x = F.pad(x, widths)
    return x, S


def _tril(L: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))


# ===========================================================================
# Mamba-2 (SSD)
# ===========================================================================


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head
    return d_in, nh, cfg.ssm_head, cfg.ssm_state


class Mamba(torch.nn.Module):
    """``in_proj`` (d, 2 d_in + 2 N + nh), ``conv_w`` (K, d_in), ``conv_b``,
    ``A_log``/``D``/``dt_bias`` (nh,) float32, ``norm`` (d_in,), ``out_proj``."""

    def __init__(self, cfg: ModelConfig, dtype, generator: torch.Generator, device=None):
        super().__init__()
        d = cfg.d_model
        d_in, nh, P, N = mamba_dims(cfg)
        init = dict(generator=generator, device=device)
        self.in_proj = _param(dense_init((d, 2 * d_in + 2 * N + nh), dtype=dtype, **init))
        conv = torch.randn((cfg.ssm_conv, d_in), dtype=torch.float32, **init) * 0.1
        self.conv_w = _param(conv.to(dtype))
        self.conv_b = _param(torch.zeros(d_in, dtype=dtype, device=device))
        self.A_log = _param(torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                                   device=device)))
        self.D = _param(torch.ones(nh, dtype=torch.float32, device=device))
        self.dt_bias = _param(torch.zeros(nh, dtype=torch.float32, device=device))
        self.norm = _param(torch.zeros(d_in, dtype=dtype, device=device))
        self.out_proj = _param(dense_init((d_in, d), dtype=dtype,
                                          scale=1.0 / (2 * cfg.n_layers) ** 0.5, **init))


def init_mamba(cfg: ModelConfig, dtype, generator: torch.Generator, device=None) -> Mamba:
    return Mamba(cfg, dtype, generator, device)


def _mamba_split(p: Mamba, x: torch.Tensor, cfg: ModelConfig):
    d_in, nh, P, N = mamba_dims(cfg)
    zxbcdt = x @ p.in_proj
    return torch.split(zxbcdt, [d_in, d_in, N, N, nh], dim=-1)  # z, xs, B, C, dt


def _causal_conv(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  xs (B,S,D); w (K,D).  Returns
    (out, new_state) with state = last K-1 inputs."""
    K = w.shape[0]
    B, S, D = xs.shape
    if state is None:
        state = torch.zeros((B, K - 1, D), dtype=xs.dtype, device=xs.device)
    xcat = torch.cat([state, xs], dim=1)  # (B, S+K-1, D)
    out = sum(xcat[:, i: i + S] * w[i][None, None, :] for i in range(K))
    new_state = xcat[:, S:, :] if K > 1 else state
    return F.silu(out + b), new_state


def mamba_forward(
    p: Mamba, x: torch.Tensor, cfg: ModelConfig, state: Optional[Dict] = None
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence Mamba (chunked SSD).  x (B,S,d) -> (out, new_state)."""
    B, S, d = x.shape
    d_in, nh, P, N = mamba_dims(cfg)
    dev = x.device
    z, xs, Bm, Cm, dt = _mamba_split(p, x, cfg)
    conv_state = state["conv"] if state else None
    xs, conv_state = _causal_conv(xs, p.conv_w, p.conv_b, conv_state)

    dt = F.softplus(dt.float() + p.dt_bias)  # (B,S,nh)
    A = -torch.exp(p.A_log)  # (nh,)
    loga = dt * A[None, None, :]  # (B,S,nh) log-decay per step
    xh = xs.float().reshape(B, S, nh, P)
    Bm = Bm.float()  # (B,S,N) shared across heads
    Cm = Cm.float()

    L = min(CHUNK, max(16, S))
    xh, _ = _pad_to_chunks(xh, 1, L)
    Bp, _ = _pad_to_chunks(Bm, 1, L)
    Cp, _ = _pad_to_chunks(Cm, 1, L)
    la, _ = _pad_to_chunks(loga, 1, L)
    dtp, _ = _pad_to_chunks(dt, 1, L)
    nC = xh.shape[1] // L
    xh = xh.reshape(B, nC, L, nh, P)
    Bp = Bp.reshape(B, nC, L, N)
    Cp = Cp.reshape(B, nC, L, N)
    la = la.reshape(B, nC, L, nh)
    dtp = dtp.reshape(B, nC, L, nh)

    S_prev = state["ssm"] if state else torch.zeros((B, nh, P, N), dtype=torch.float32,
                                                    device=dev)
    mask = _tril(L, dev)[None, :, :, None]
    ys = []
    for c in range(nC):  # the reference's lax.scan over chunks
        xc, Bc, Cc, lac, dtc = xh[:, c], Bp[:, c], Cp[:, c], la[:, c], dtp[:, c]
        cum = torch.cumsum(lac, dim=1)  # (B,L,nh)
        # intra-chunk: y[t] += sum_{s<=t} exp(cum_t - cum_s) dt_s (Cc_t.Bc_s) x_s
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B,L,L,nh)
        # mask BEFORE exp: s > t gives seg >= 0, which overflows
        decay = torch.exp(torch.where(mask, seg, -1e30))
        cb = torch.einsum("btn,bsn->bts", Cc, Bc)  # (B,L,L)
        w = cb[:, :, :, None] * decay * dtc[:, None, :, :]  # (B,t,s,nh)
        y = torch.einsum("btsh,bshp->bthp", w, xc)
        # inter-chunk: y[t] += Cc_t . (exp(cum_t) * S_prev)
        y = y + torch.einsum("btn,bth,bhpn->bthp", Cc, torch.exp(cum), S_prev)
        # state advance: S_new = exp(cum_L) S_prev + sum_s exp(cum_L - cum_s) dt_s B_s x_s
        tail = torch.exp(cum[:, -1:, :] - cum)  # (B,L,nh)
        S_prev = (torch.exp(cum[:, -1, :])[:, :, None, None] * S_prev
                  + torch.einsum("bsh,bshp,bsn->bhpn", tail * dtc, xc, Bc))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, nC * L, nh, P)[:, :S]
    y = y + xh.reshape(B, nC * L, nh, P)[:, :S] * p.D[None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.norm)
    return y @ p.out_proj, {"conv": conv_state, "ssm": S_prev}


def mamba_decode(
    p: Mamba, x: torch.Tensor, cfg: ModelConfig, state: Dict
) -> Tuple[torch.Tensor, Dict]:
    """Single-step Mamba.  x (B,1,d)."""
    B = x.shape[0]
    d_in, nh, P, N = mamba_dims(cfg)
    z, xs, Bm, Cm, dt = _mamba_split(p, x, cfg)
    xs, conv_state = _causal_conv(xs, p.conv_w, p.conv_b, state["conv"])
    dt = F.softplus(dt.float() + p.dt_bias)[:, 0]  # (B,nh)
    A = -torch.exp(p.A_log)
    da = torch.exp(dt * A[None, :])  # (B,nh)
    xh = xs.float().reshape(B, nh, P)
    Bv = Bm.float()[:, 0]  # (B,N)
    Cv = Cm.float()[:, 0]
    S_new = da[:, :, None, None] * state["ssm"] + torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bv)
    y = torch.einsum("bn,bhpn->bhp", Cv, S_new) + xh * p.D[None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.norm)
    return y @ p.out_proj, {"conv": conv_state, "ssm": S_new}


def mamba_init_state(cfg: ModelConfig, batch: int, dtype, device=None) -> Dict:
    d_in, nh, P, N = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, P, N), dtype=torch.float32, device=device),
    }


# ===========================================================================
# mLSTM (xLSTM): matrix memory, exponential gating, chunkwise parallel
# ===========================================================================


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.n_heads
    return d_in, nh, d_in // nh


class MLSTM(torch.nn.Module):
    """``wq``/``wk``/``wv``/``wo_gate`` (d, d_in), ``wif`` (d, 2 nh) and
    ``b_if`` (2 nh,) float32, ``out_proj`` (d_in, d)."""

    def __init__(self, cfg: ModelConfig, dtype, generator: torch.Generator, device=None):
        super().__init__()
        d = cfg.d_model
        d_in, nh, dh = mlstm_dims(cfg)
        init = dict(generator=generator, device=device)
        self.wq = _param(dense_init((d, d_in), dtype=dtype, **init))
        self.wk = _param(dense_init((d, d_in), dtype=dtype, **init))
        self.wv = _param(dense_init((d, d_in), dtype=dtype, **init))
        self.wif = _param(dense_init((d, 2 * nh), dtype=torch.float32, **init))
        self.b_if = _param(torch.cat([torch.zeros(nh, device=device),
                                      3.0 * torch.ones(nh, device=device)]))
        self.wo_gate = _param(dense_init((d, d_in), dtype=dtype, **init))
        self.out_proj = _param(dense_init((d_in, d), dtype=dtype,
                                          scale=1.0 / (2 * cfg.n_layers) ** 0.5, **init))


def init_mlstm(cfg: ModelConfig, dtype, generator: torch.Generator, device=None) -> MLSTM:
    return MLSTM(cfg, dtype, generator, device)


def _mlstm_qkvif(p: MLSTM, x: torch.Tensor, cfg: ModelConfig):
    d_in, nh, dh = mlstm_dims(cfg)
    B, S, _ = x.shape
    q = (x @ p.wq).reshape(B, S, nh, dh) / (dh**0.5)
    k = (x @ p.wk).reshape(B, S, nh, dh)
    v = (x @ p.wv).reshape(B, S, nh, dh)
    i_f = x.float() @ p.wif + p.b_if
    i_pre, f_pre = torch.chunk(i_f, 2, dim=-1)  # (B,S,nh)
    logf = F.logsigmoid(f_pre)
    o = torch.sigmoid(x @ p.wo_gate)
    return q, k, v, i_pre, logf, o


def mlstm_forward(
    p: MLSTM, x: torch.Tensor, cfg: ModelConfig, state: Optional[Dict] = None
) -> Tuple[torch.Tensor, Dict]:
    """Chunkwise-parallel mLSTM with stabilized exponential gating."""
    B, S, d = x.shape
    d_in, nh, dh = mlstm_dims(cfg)
    dev = x.device
    q, k, v, i_pre, logf, o = _mlstm_qkvif(p, x, cfg)

    L = min(CHUNK, max(16, S))
    qp, _ = _pad_to_chunks(q.float(), 1, L)
    kp, _ = _pad_to_chunks(k.float(), 1, L)
    vp, _ = _pad_to_chunks(v.float(), 1, L)
    ip, _ = _pad_to_chunks(i_pre, 1, L)
    # padding must not contribute: i = -inf on pad
    if qp.shape[1] != S:
        padmask = torch.arange(qp.shape[1], device=dev) >= S
        ip = torch.where(padmask[None, :, None], -1e30, ip)
    fp, _ = _pad_to_chunks(logf, 1, L)
    nC = qp.shape[1] // L

    def rs(t):
        return t.reshape(B, nC, L, *t.shape[2:])

    qp, kp, vp, ip, fp = map(rs, (qp, kp, vp, ip, fp))

    if state is None:
        state = mlstm_init_state(cfg, B, dev)
    C_prev, n_prev, m_prev = state["C"], state["n"], state["m"]
    mask = _tril(L, dev)[None, :, :, None]
    hs = []
    for c in range(nC):  # the reference's lax.scan over chunks
        qc, kc, vc, ic, fc = qp[:, c], kp[:, c], vp[:, c], ip[:, c], fp[:, c]
        cumf = torch.cumsum(fc, dim=1)  # (B,L,nh)
        # log-weights: intra  w_ts = cumf_t - cumf_s + i_s   (s <= t)
        #              inter  g_t  = cumf_t + m_prev
        intra = cumf[:, :, None, :] - cumf[:, None, :, :] + ic[:, None, :, :]
        intra = torch.where(mask, intra, -1e30)
        inter = cumf + m_prev[:, None, :]  # (B,L,nh)
        m_t = torch.maximum(intra.amax(dim=2), inter)  # (B,L,nh)
        wi = torch.exp(intra - m_t[:, :, None, :])  # (B,t,s,nh)
        wg = torch.exp(inter - m_t)  # (B,L,nh)
        qk = torch.einsum("bthd,bshd->btsh", qc, kc)
        num = (torch.einsum("btsh,bshd->bthd", qk * wi, vc)
               + wg[..., None] * torch.einsum("bthd,bhde->bthe", qc, C_prev))
        den = (torch.einsum("btsh,bsh->bth", qk * wi, torch.ones_like(ic))
               + wg * torch.einsum("bthd,bhd->bth", qc, n_prev))
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # carry update
        m_new = torch.maximum(cumf[:, -1, :] + m_prev,
                              (cumf[:, -1:, :] - cumf + ic).amax(dim=1))
        tailw = torch.exp(cumf[:, -1:, :] - cumf + ic - m_new[:, None, :])  # (B,L,nh)
        decay = torch.exp(cumf[:, -1, :] + m_prev - m_new)  # (B,nh)
        C_prev = (decay[:, :, None, None] * C_prev
                  + torch.einsum("bsh,bshd,bshe->bhde", tailw, kc, vc))
        n_prev = decay[:, :, None] * n_prev + torch.einsum("bsh,bshd->bhd", tailw, kc)
        m_prev = m_new
    h = torch.stack(hs, dim=1).reshape(B, nC * L, nh, dh)[:, :S]
    h = (h.reshape(B, S, d_in) * o.float()).to(x.dtype)
    return h @ p.out_proj, {"C": C_prev, "n": n_prev, "m": m_prev}


def mlstm_decode(
    p: MLSTM, x: torch.Tensor, cfg: ModelConfig, state: Dict
) -> Tuple[torch.Tensor, Dict]:
    B = x.shape[0]
    d_in, nh, dh = mlstm_dims(cfg)
    q, k, v, i_pre, logf, o = _mlstm_qkvif(p, x, cfg)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    i_pre, logf = i_pre[:, 0], logf[:, 0]  # (B,nh)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, i_pre)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(i_pre - m_new)
    C_new = (fw[:, :, None, None] * C
             + iw[:, :, None, None] * torch.einsum("bhd,bhe->bhde", k, v))
    n_new = fw[:, :, None] * n + iw[:, :, None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    h = (h.reshape(B, 1, d_in) * o.float()).to(x.dtype)
    return h @ p.out_proj, {"C": C_new, "n": n_new, "m": m_new}


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> Dict:
    d_in, nh, dh = mlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, nh, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
    }


# ===========================================================================
# sLSTM (xLSTM): scalar memory + exponential gating; sequential scan
# ===========================================================================

_GATES = ("i", "f", "z", "o")


class SLSTM(torch.nn.Module):
    """``w{g}`` (d, d), ``r{g}`` (d, d) and ``b{g}`` (d,) for the gates
    i, f, z, o, all float32 (``bf`` starts at 3)."""

    def __init__(self, cfg: ModelConfig, dtype, generator: torch.Generator, device=None):
        super().__init__()
        d = cfg.d_model
        init = dict(generator=generator, dtype=torch.float32, device=device)
        for g in _GATES:
            setattr(self, f"w{g}", _param(dense_init((d, d), **init)))
            setattr(self, f"r{g}", _param(dense_init((d, d), scale=0.5, **init)))
            fill = 3.0 if g == "f" else 0.0
            setattr(self, f"b{g}", _param(torch.full((d,), fill, device=device)))


def init_slstm(cfg: ModelConfig, dtype, generator: torch.Generator, device=None) -> SLSTM:
    return SLSTM(cfg, dtype, generator, device)


def slstm_forward(
    p: SLSTM, x: torch.Tensor, cfg: ModelConfig, state: Optional[Dict] = None
) -> Tuple[torch.Tensor, Dict]:
    B, S, d = x.shape
    xf = x.float()
    # input contributions for all steps (the only matmuls over S)
    pre = {g: xf @ getattr(p, f"w{g}") + getattr(p, f"b{g}") for g in _GATES}
    if state is None:
        state = slstm_init_state(cfg, B, d, x.device)
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    hs = []
    for t in range(S):  # the reference's lax.scan over time steps
        i_pre = pre["i"][:, t] + h @ p.ri
        f_pre = pre["f"][:, t] + h @ p.rf
        z = torch.tanh(pre["z"][:, t] + h @ p.rz)
        o = torch.sigmoid(pre["o"][:, t] + h @ p.ro)
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        iw = torch.exp(i_pre - m_new)
        fw = torch.exp(logf + m - m_new)
        c = fw * c + iw * z
        n = fw * n + iw
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).to(x.dtype)
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_decode(p: SLSTM, x: torch.Tensor, cfg: ModelConfig, state: Dict):
    return slstm_forward(p, x, cfg, state)


def slstm_init_state(cfg: ModelConfig, batch: int, d: Optional[int] = None,
                     device=None) -> Dict:
    d = d or cfg.d_model

    def zeros():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)

    return {"h": zeros(), "c": zeros(), "n": zeros(),
            "m": torch.full((batch, d), -1e30, dtype=torch.float32, device=device)}
