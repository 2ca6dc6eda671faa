"""The comparison that decides ``correct``.

After the window, with the program's state freed, the reference judges
what the timed path produced:

* ``bad_wires``: every response wire of the window is parsed with the
  frozen codec; one that does not parse, names another request, holds
  another number of outputs than its request had prompts, or an output
  of another length than ``max_new`` or with a token outside the
  vocabulary, is bad;
* ``stream_mismatch`` (streamed cells): every stream's tokens as they
  reached the ingress, in step order, equal its response wire's output,
  and every stream had a first token;
* the logit gaps: a sample of served sequences, drawn from the seed with
  the longest prompt in it, runs through the float32 reference (the
  family's ``forward``) as its padded prompt followed by its served
  tokens; at each served position, the reference's best logit minus the
  logit of the token the program served.  A cell's ``check`` names the
  statistics it holds to a limit (``STATS``): ``logit_gap``, the widest gap;
  ``logit_gap_seq_median``, the median over sequences of each sequence's
  mean gap; ``logit_gap_seq_third``, the third largest of those means.
  An MoE configuration needs every sequence of one call (its capacity
  groups span the call's batch), so its sample is one call drawn from the
  seed; there a routing decision that bfloat16 and float32 take
  differently moves whole sequences, so its widest gap does not separate
  a sound run from the control.  The median over sequences does, and
  sees a fault in every sequence; the third largest sees one in three or
  more of the call's sequences, such as half the slots served wrong.

``control=True`` also reads the control: the reference in float8 at the
same positions, the gap of the token it puts first.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import weights
from .codec import decode_response
from .model import moe_capacity

#: sequences of one reference forward (dense configurations)
BLOCK = 8
#: tokens per capacity group of the program's MoE dispatch
TOKEN_GROUP = 8192
#: the gap statistics a cell's ``check`` may hold a limit for
STATS = {"logit_gap": "max", "logit_gap_seq_median": "seq_mean_median",
         "logit_gap_seq_third": "seq_mean_third"}


def moe_groups(n: int, slots: int, pad_to: int, max_new: int, dm: dict,
               device) -> List[Tuple[torch.Tensor, int]]:
    """The MoE token groups of a call of ``n`` sequences, over the flat
    (n, pad_to + max_new - 1) tokens of the reference's batch: the
    program admits the whole call in one prefill of ``slots`` rows
    (row-major, 8192 tokens a group, each with the capacity of 8192) and
    then decodes every slot at once, one group of ``n`` tokens a step."""
    if n != slots:
        raise ValueError(f"the MoE reference models a call that fills every slot at once; "
                         f"got {n} sequences for {slots} slots")
    L = pad_to + max_new - 1
    cap = lambda t: moe_capacity(t, dm["E"], dm["k"], dm["cf"])  # noqa: E731
    flat = (torch.arange(n, device=device)[:, None] * L
            + torch.arange(pad_to, device=device)[None, :]).reshape(-1)
    T = flat.numel()
    if T <= TOKEN_GROUP:
        groups = [(flat, cap(T))]
    elif T % TOKEN_GROUP:
        raise ValueError(f"{T} prefill tokens do not fill whole groups of {TOKEN_GROUP}")
    else:
        groups = [(g, cap(TOKEN_GROUP)) for g in flat.split(TOKEN_GROUP)]
    rows = torch.arange(n, device=device) * L
    for j in range(1, max_new):
        groups.append((rows + pad_to + j - 1, cap(n)))
    return groups


def _wire_ok(wire, rid: int, prompts, max_new: int, vocab: int) -> Optional[List[List[int]]]:
    try:
        got_rid, outs = decode_response(wire)
    except (ValueError, TypeError):
        return None
    if got_rid != rid or len(outs) != len(prompts):
        return None
    if any(len(o) != max_new or min(o, default=0) < 0 or max(o, default=0) >= vocab
           for o in outs):
        return None
    return outs


def judge(config: dict, mix: dict, workload: dict, calls: Sequence[dict], seed: int,
          device, *, family, control: bool = False) -> Dict[str, object]:
    """``calls``: each ``{"reqs": [(rid, prompts)], "responses": [wire],
    "streamed": {(m, j): [token, ...]} or None}``; ``family``, the
    configuration's (``cells.load_family``), gives ``dims``, ``spec`` and
    ``forward``.  Returns the compared numbers with their limits
    (``checks``), the failed request count, the sampled sequence count
    and, with ``control``, the control's gap."""
    dm = family.dims(config)
    pad_to, max_new = int(mix["pad_to"]), int(mix["max_new"])
    lim = workload["check"]
    bad = mismatch = 0
    failed = 0
    seqs = []  # (call index, prompt, served)
    per_call_ok = []
    for ci, c in enumerate(calls):
        ok_all = True
        responses = c["responses"] or []
        for m, (rid, prompts) in enumerate(c["reqs"]):
            outs = _wire_ok(responses[m], rid, prompts, max_new, dm["V"]) \
                if m < len(responses) else None
            if outs is None:
                bad += 1
                failed += 1
                ok_all = False
                continue
            if c.get("streamed") is not None:
                wrong = sum(c["streamed"].get((m, j)) != outs[j] for j in range(len(prompts)))
                mismatch += wrong
                failed += bool(wrong)
            for j, p in enumerate(prompts):
                seqs.append((ci, np.asarray(p), outs[j]))
        per_call_ok.append(ok_all)

    rng = np.random.default_rng(np.random.SeedSequence([abs(int(seed)) % (1 << 64), 4]))
    groups = None
    if dm["E"]:
        whole = [ci for ci, ok in enumerate(per_call_ok) if ok]
        chosen = whole[rng.integers(len(whole))] if whole else None
        pick = [s for s in seqs if s[0] == chosen]
        if pick:
            groups = moe_groups(len(pick), int(workload["slots"]), pad_to, max_new, dm, device)
        blocks = [pick] if pick else []
    else:
        k = min(int(lim["sample"]), len(seqs))
        if k:
            longest = int(np.argmax([len(s[1]) for s in seqs]))
            rest = [i for i in range(len(seqs)) if i != longest]
            idx = [longest] + list(rng.choice(rest, size=k - 1, replace=False)) if k > 1 \
                else [longest]
            pick = [seqs[i] for i in idx]
        else:
            pick = []
        blocks = [pick[a:a + BLOCK] for a in range(0, len(pick), BLOCK)]

    gaps, ctl = [], []
    if blocks:
        W = weights.make(config, seed, device, family.spec)
        for blk in blocks:
            toks = np.zeros((len(blk), pad_to + max_new - 1), np.int64)
            served = np.zeros((len(blk), max_new), np.int64)
            for r, (_, p, out) in enumerate(blk):
                if len(p) > pad_to:
                    raise ValueError("a prompt longer than pad_to")
                toks[r, :len(p)] = p
                toks[r, pad_to:] = out[:-1]
                served[r] = out
            t = torch.from_numpy(toks).to(device)
            s = torch.from_numpy(served).to(device)
            logits = family.forward(W, config, t, pad_to - 1, groups)
            best = logits.max(-1).values
            gaps.append((best - logits.gather(-1, s[..., None])[..., 0]).cpu())
            if control:
                low = family.forward(W, config, t, pad_to - 1, groups,
                                     quant="fp8").argmax(-1)
                ctl.append((best - logits.gather(-1, low[..., None])[..., 0]).cpu())
            del logits, best
        del W
    stats = gap_stats(gaps)
    checks = {name: (stats[STATS[name]] if stats else float("inf"), float(lim[name]))
              for name in STATS if name in lim}
    if not checks:
        raise ValueError(f"{workload['name']}: check names none of {sorted(STATS)}")
    checks["bad_wires"] = (bad, 0)
    if any(c.get("streamed") is not None for c in calls):
        checks["stream_mismatch"] = (mismatch, 0)
    return {"checks": checks, "failed": failed, "sampled": sum(len(b) for b in blocks),
            "readings": {"program": stats, "control": gap_stats(ctl)}}


def gap_stats(gaps: List[torch.Tensor]) -> Optional[Dict[str, object]]:
    """Summaries of per-position gaps (sequences x served positions): the
    widest, the mean, and the median, the third largest and the largest
    three of the sequences' own means."""
    if not gaps:
        return None
    g = torch.cat([x.reshape(-1) for x in gaps]).double()
    per_seq = torch.cat([x.double().mean(1) for x in gaps])
    top3 = [float(v) for v in per_seq.topk(min(3, len(per_seq))).values]
    return {"max": float(g.max()), "mean": float(g.mean()),
            "seq_mean_median": float(per_seq.median()), "seq_mean_third": top3[-1],
            "seq_mean_top3": top3}
