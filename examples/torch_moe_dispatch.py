"""Framed MoE dispatch on the PyTorch/CUDA port: expert token groups as
routed HGum Lists.

The twin of ``examples/moe_dispatch.py`` on ``repro_torch``.  MoE dispatch
is HGum's List-framing in disguise: each expert receives a variable-length
list of tokens, packed into fixed-capacity frames (the ``(E, C, d)`` buffer
= one frame per expert with a count header).  This demo runs the
sort-based dispatch (``repro_torch.models.ffn.moe_ffn``), prints the
per-expert fill (top-k ties broken toward the lower expert, as
``jax.lax.top_k`` breaks them), then performs the expert **all-to-all over
the routed message fabric** (``repro_torch.fabric``): every rank sends
each expert's token-id list to the rank that owns that expert as one
routed framed List, the expert riding as its ListLevel — CRC32 per frame
(B5 ``frame_batch``), multi-hop delivery, the RX split (B6) and the CRC
check on the receiving side.

The reference needs one JAX device per rank and skips the all-to-all on a
single device.  Here the ranks are a tensor axis, so all ``R = min(8,
experts)`` ranks (what the reference gets under the README's 8 simulated
devices) run on one card, always.

Run:  PYTHONPATH=src python examples/torch_moe_dispatch.py [--device cpu]

It runs on the CUDA card unless given ``--device cpu``; without a card and
without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import DeviceLike, default_device
from repro_torch.fabric import Fabric, FabricConfig
from repro_torch.models.ffn import init_moe_ffn, moe_capacity, moe_ffn

#: ranks of the all-to-all: the README's 8 simulated devices
MAX_RANKS = 8
FRAME_PHITS = 8


def route(p, x: torch.Tensor, cfg) -> Dict:
    """The MoE layer on ``x`` (B, S, d) and its routing: capacity, the
    forward's ``aux``, each token's top-k experts (flattened, token-major)
    and the tokens each expert receives."""
    with torch.no_grad():
        _, aux = moe_ffn(p, x, cfg)
        logits = x.reshape(-1, cfg.d_model).float() @ p.router
        probs = torch.softmax(logits, dim=-1)
        # lax.top_k's order: a stable descending sort, ties to the lower expert
        top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :cfg.moe_topk]
    top = top.reshape(-1).cpu().numpy()
    return {
        "capacity": moe_capacity(cfg, x.shape[0] * x.shape[1]),
        "balance_loss": float(aux["moe_balance_loss"]),
        "dropped": float(aux["moe_dropped"]),
        "top": top,
        "counts": np.bincount(top, minlength=cfg.moe_experts),
    }


def expert_all_to_all(top: np.ndarray, n_experts: int, n_ranks: int,
                      device: DeviceLike = None, frame_phits: int = FRAME_PHITS) -> Dict:
    """Rank r holds 1/R of the token stream; expert e lives on rank e % R.
    Every non-empty (rank, expert) token-id list crosses the fabric as one
    routed framed List with ListLevel e + 1.  Returns what was sent, what
    each rank received (src, expert, ids) in arrival order, the fabric's
    counts, whether delivery was bit-exact, and the seconds the exchange
    took (host clock, the card synchronised)."""
    dev = default_device(device)
    fabric = Fabric(n_ranks=n_ranks, config=FabricConfig(frame_phits=frame_phits), device=dev)
    boxes = [fabric.mailbox(r) for r in range(n_ranks)]
    owner = lambda e: e % n_ranks  # noqa: E731
    token_ids = np.arange(top.shape[0], dtype=np.uint32)
    my_slice = np.array_split(np.arange(top.shape[0]), n_ranks)

    sent = {}
    for r in range(n_ranks):
        for e in range(n_experts):
            ids = token_ids[my_slice[r]][top[my_slice[r]] == e]
            if ids.size == 0:
                continue  # absence is the empty list: empty wires are refused
            sent[(r, e)] = ids
            boxes[r].send(owner(e), ids.tobytes(), list_level=e + 1)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fabric.exchange()
    sync()
    exchange_s = time.perf_counter() - t0

    received, ok, all_ok = [], True, True
    for d in range(n_ranks):
        got = []
        for dl in boxes[d].recv():
            e = dl.list_level - 1  # the expert rode as the ListLevel
            ids = np.frombuffer(dl.wire, np.uint32)
            all_ok &= dl.ok
            ok &= (dl.ok and owner(e) == d and (dl.src, e) in sent
                   and np.array_equal(sent[(dl.src, e)], ids))
            got.append((dl.src, e, ids))
        received.append(got)
    return {
        "n_ranks": fabric.n_ranks, "sent": sent, "received": received,
        "frames_routed": fabric.frames_routed, "crc_ok": fabric.last_crc_ok,
        "all_ok": all_ok, "bit_exact": ok and len(sent) == sum(map(len, received)),
        "exchange_s": exchange_s,
    }


def rank_loads(received) -> list:
    """Per rank: {expert: tokens received} over the experts with tokens."""
    loads = []
    for got in received:
        per_expert: Dict[int, int] = {}
        for _, e, ids in got:
            per_expert[e] = per_expert.get(e, 0) + len(ids)
        loads.append({e: n for e, n in sorted(per_expert.items()) if n})
    return loads


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    cfg = smoke_config(get_config("mixtral-8x22b"))
    g = torch.Generator(device=dev).manual_seed(0)
    p = init_moe_ffn(cfg, torch.float32, g, dev)
    B, S = 4, 32
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev)

    r = route(p, x, cfg)
    C = r["capacity"]
    print(f"experts={cfg.moe_experts} top-{cfg.moe_topk} capacity={C}")
    print(f"balance_loss={r['balance_loss']:.4f} dropped={r['dropped']:.3f}")
    counts = r["counts"]
    for e, c in enumerate(counts):
        bar = "#" * int(30 * c / counts.max())
        print(f"  expert {e}: {c:4d} tokens (fill {c/C:5.1%}) {bar}")

    R = min(MAX_RANKS, cfg.moe_experts)
    out = expert_all_to_all(r["top"], cfg.moe_experts, R, dev)
    print(f"\nexpert all-to-all over the fabric on {dev}: {out['n_ranks']} ranks, "
          f"{out['frames_routed']} frames routed, crc_ok={out['crc_ok']}, "
          f"exchange {1e3 * out['exchange_s']:.3f} ms")
    for d, (got, loads) in enumerate(zip(out["received"], rank_loads(out["received"]))):
        print(f"  rank {d}: {len(got)} routed lists, expert loads {loads}")
    print(f"fabric all-to-all bit-exact: {out['bit_exact']}")
    assert out["all_ok"] and out["crc_ok"], "corrupt frames in the all-to-all"
    assert out["bit_exact"], "the all-to-all did not deliver what was sent"
    return {**r, **out}


if __name__ == "__main__":
    main()
