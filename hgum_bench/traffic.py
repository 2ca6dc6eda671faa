"""The one traffic generator: every mix is a data file ``traffic/<name>.json``.

Modelled on the program's ``launch.serve.synthetic_wires`` and frozen
here.  A mix fixes:

* ``prompts_per_wire``: prompts in one request wire;
* ``prompt_len``: ``{"dist": "uniform" | "loguniform", "lo": a, "hi": b}``
  (inclusive);
* ``pad_to`` and ``max_new``: the serving call's prompt cap and tokens
  generated per prompt.

The harness sends the calls in a closed loop (``harness.py``).

Every call of a cell holds the same multiset of prompt lengths, the
``n`` quantiles of the distribution at ``(i + 0.5) / n``; the seed only
orders them and draws the token ids (from ``[2, vocab)``), so two seeds
do the same work.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .reference.codec import encode_request

ROOT = Path(__file__).resolve().parent


def load(name: str, root: Path = ROOT) -> dict:
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    if mix.get("name") != name:
        raise ValueError(f"traffic/{name}.json names itself {mix.get('name')!r}")
    return mix


def lengths(dist: dict, n: int) -> np.ndarray:
    """The ``n`` stratified prompt lengths of a call, in ascending order."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if dist["dist"] == "uniform":
        out = lo + np.floor(u * (hi - lo + 1))
    elif dist["dist"] == "loguniform":
        out = np.rint(lo * (hi / lo) ** u)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(out, lo, hi).astype(np.int64)


def call(mix: dict, n_wires: int, vocab: int, seed: int,
         index: int) -> List[Tuple[int, List[np.ndarray]]]:
    """Call ``index`` of a run: ``n_wires`` requests ``(req_id, prompts)``."""
    k = int(mix["prompts_per_wire"])
    rng = np.random.default_rng(np.random.SeedSequence([abs(int(seed)) % (1 << 64), 2, index]))
    lens = rng.permutation(lengths(mix["prompt_len"], n_wires * k))
    reqs = []
    for w in range(n_wires):
        prompts = [rng.integers(2, vocab, int(n), dtype=np.int64) for n in lens[w * k:(w + 1) * k]]
        reqs.append(((index << 20) + w + 1, prompts))
    return reqs


def wires(reqs) -> List[bytes]:
    return [encode_request(rid, prompts) for rid, prompts in reqs]
