"""The readers of the program's own timeline (``programtrace`` and the
five metrics on it) on the CPU at tiny sizes: each reads a positive value
in a traced batched run, dense and MoE, and none is there, with the run
still correct, for a program whose ``serve_requests`` takes no trace."""
from __future__ import annotations

import inspect
import json
from unittest import mock

import pytest

from .tiny import make_tree, run

READERS = ["des_ms", "ser_ms", "prefill_ms", "decode_enqueue_ms", "tick_gap_ms"]
CELLS = {"tiny-dense.timeline": ("tiny-dense", 3, 4), "tiny-moe.timeline": ("tiny-moe", 4, 8)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tree(tmp_path_factory.mktemp("hgum_bench_timeline"))
    for name, (config, wires, slots) in CELLS.items():
        w = {"name": name, "config": config, "traffic": "tiny", "plane": "batched", "chips": 1,
             "wires_per_call": wires, "slots": slots, "plane_args": {}, "why": "a CPU test",
             "end_to_end": ["tokens_per_s", "setup_s"],
             "per_layer": ["decode_step_ms", *READERS],
             "check": {"logit_gap": 1e-3, "sample": 4}}
        (root / "workloads" / f"{name}.json").write_text(json.dumps(w))
    return root


@pytest.mark.parametrize("name", sorted(CELLS))
def test_readers_read_the_program_spans(root, name):
    out = run(root, name, seed=2 ** 31 + 29, trace=True, seconds=0.2)
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {"decode_step_ms", *READERS}
    assert all(out["metrics"][m]["value"] > 0 for m in READERS)
    assert {out["metrics"][m]["unit"] for m in READERS} == {"ms"}
    # the untraced run reads its end-to-end metrics alone
    plain = run(root, name, seed=2 ** 31 + 29, trace=False, seconds=0.0)
    assert plain["correct"] and set(plain["metrics"]) == {"tokens_per_s", "setup_s"}


def test_a_program_without_spans_reads_nothing(root):
    import repro_torch.launch.serve as serve

    orig = serve.serve_requests

    def untraced(params, cfg, wires, max_new=16, pad_to=64, slots=8, admit_cap=None,
                 device=None):
        return orig(params, cfg, wires, max_new=max_new, pad_to=pad_to, slots=slots,
                    admit_cap=admit_cap, device=device)

    assert "trace" not in inspect.signature(untraced).parameters
    with mock.patch.object(serve, "serve_requests", untraced):
        out = run(root, "tiny-moe.timeline", seed=2 ** 31 + 31, trace=True, seconds=0.0)
    assert out["correct"] and set(out["metrics"]) == {"decode_step_ms"}
    assert serve.serve_requests is orig
