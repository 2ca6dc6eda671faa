"""The model's weights, made from the seed on the device.

Both sides get the same tensors: the benchmark loads them into the
program's module by name, and the reference makes them again from the
same seed after the program's state is freed.  A configuration file
(``configs/<name>.json``, published config.json keys) fixes the names and
shapes; every matrix is ``x @ W`` shaped ``(d_in, d_out)``:

* ``embed`` (V, d) and ``lm_head`` (d, V), std 0.02, V rounded up to 128;
* per layer ``ln1.scale`` and ``ln2.scale`` (zeros: the norm multiplies
  by ``1 + scale``), ``attn.wq/wk/wv/wo``, then ``ffn.wi/wg/wo`` or
  ``moe.router`` (float32) and ``moe.wi/wg/wo`` (E, d_in, d_out);
* ``final_norm.scale``.

A matrix has std ``1 / sqrt(d_in)``, and the output projections of a
layer a further ``1 / sqrt(2 * n_layers)``.  All values are drawn in a
few large calls of one generator on the device: one flat buffer per
dtype, filled in chunks of 2**30, then scaled leaf by leaf in place.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

CHUNK = 1 << 30
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(cfg: dict) -> dict:
    """The sizes the reference and the FLOP count read, by short names."""
    d, nq = cfg["hidden_size"], cfg["num_attention_heads"]
    V = cfg["vocab_size"]
    return {
        "d": d, "nq": nq, "nkv": cfg["num_key_value_heads"],
        "hd": cfg.get("head_dim") or d // nq,
        "ff": cfg["intermediate_size"], "L": cfg["num_hidden_layers"],
        "V": V, "Vp": -(-V // 128) * 128,
        "E": cfg.get("num_local_experts", 0), "k": cfg.get("num_experts_per_tok", 0),
        "eps": cfg["rms_norm_eps"], "theta": cfg["rope_theta"],
        "window": cfg.get("sliding_window"),
        "cf": cfg.get("capacity_factor", 1.25),
        "tied": bool(cfg.get("tie_word_embeddings", False)),
    }


def decoder_overrides(cfg: dict) -> dict:
    """The keyword arguments that make the program's ``ModelConfig`` this
    decoder: the Llama/Mixtral block with every number of the
    configuration file put in (the default family's
    ``program_overrides``)."""
    m = dims(cfg)
    kw = dict(n_layers=m["L"], d_model=m["d"], n_heads=m["nq"], n_kv=m["nkv"],
              head_dim=cfg.get("head_dim"), d_ff=m["ff"], vocab=m["V"],
              norm="rmsnorm", norm_eps=m["eps"], rope_theta=m["theta"], act="swiglu",
              tie_embeddings=m["tied"], window=m["window"], dtype=cfg["torch_dtype"],
              moe_experts=m["E"], local_global_alternate=False, attn_softcap=None,
              final_softcap=None, embed_scale=False, sandwich_norm=False,
              layer_pattern="attn", family="lm")
    if m["E"]:
        kw.update(moe_topk=m["k"], capacity_factor=m["cf"], moe_dff=None, moe_every=1,
                  moe_offset=0)
    return kw


def spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, dtype, std) of every weight; std 0 means zeros."""
    m = dims(cfg)
    d, hd, nq, nkv, ff, L = m["d"], m["hd"], m["nq"], m["nkv"], m["ff"], m["L"]
    dt = cfg["torch_dtype"]
    out_scale = 1.0 / math.sqrt(2 * L)
    out = [("embed", (m["Vp"], d), dt, 0.02)]
    for i in range(L):
        p = f"layers.{i}."
        out += [
            (p + "ln1.scale", (d,), dt, 0.0),
            (p + "attn.wq", (d, nq * hd), dt, d ** -0.5),
            (p + "attn.wk", (d, nkv * hd), dt, d ** -0.5),
            (p + "attn.wv", (d, nkv * hd), dt, d ** -0.5),
            (p + "attn.wo", (nq * hd, d), dt, (nq * hd) ** -0.5 * out_scale),
            (p + "ln2.scale", (d,), dt, 0.0),
        ]
        if m["E"]:
            E = m["E"]
            out += [
                (p + "moe.router", (d, E), "float32", d ** -0.5),
                (p + "moe.wi", (E, d, ff), dt, d ** -0.5),
                (p + "moe.wo", (E, ff, d), dt, ff ** -0.5 * out_scale),
                (p + "moe.wg", (E, d, ff), dt, d ** -0.5),
            ]
        else:
            out += [
                (p + "ffn.wi", (d, ff), dt, d ** -0.5),
                (p + "ffn.wo", (ff, d), dt, ff ** -0.5 * out_scale),
                (p + "ffn.wg", (d, ff), dt, d ** -0.5),
            ]
    out.append(("final_norm.scale", (d,), dt, 0.0))
    if not m["tied"]:
        out.append(("lm_head", (d, m["Vp"]), dt, 0.02))
    return out


def seed_of(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one use of the run's ``--seed``."""
    ss = np.random.SeedSequence([abs(int(seed)) % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] % (1 << 63))


def make(cfg: dict, seed: int, device, spec_of=spec) -> Dict[str, torch.Tensor]:
    """Every weight of ``spec_of(cfg)`` (a family's ``spec``; the default
    decoder's by default), on ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 1))
    leaves = spec_of(cfg)
    flats = {}
    for dt in sorted({dt for _, _, dt, std in leaves if std}):
        n = sum(math.prod(s) for _, s, d2, std in leaves if d2 == dt and std)
        flat = torch.empty(n, dtype=_DTYPES[dt], device=device)
        for a in range(0, n, CHUNK):
            flat[a:a + CHUNK].normal_(generator=gen)
        flats[dt] = [flat, 0]
    out = {}
    for name, shape, dt, std in leaves:
        if not std:
            out[name] = torch.zeros(shape, dtype=_DTYPES[dt], device=device)
            continue
        flat, off = flats[dt]
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        flats[dt][1] = off + n
    return out
