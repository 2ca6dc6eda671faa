"""Tiny cells for the CPU tests: a copy of the benchmark's tree with small
configurations and mixes added as new files."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
SRC = BENCH.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

CONFIGS = {
    "tiny-dense": {"name": "tiny-dense", "arch": "yi-6b", "hidden_size": 64,
                   "intermediate_size": 128, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 512,
                   "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "tie_word_embeddings": False,
                   "torch_dtype": "float32"},
    "tiny-moe": {"name": "tiny-moe", "arch": "mixtral-8x22b", "hidden_size": 64,
                 "intermediate_size": 96, "num_attention_heads": 4, "num_key_value_heads": 2,
                 "num_hidden_layers": 2, "num_local_experts": 4, "num_experts_per_tok": 2,
                 "vocab_size": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
                 "sliding_window": None, "tie_word_embeddings": False,
                 "torch_dtype": "float32", "capacity_factor": 1.0},
}
#: MoE on odd layers only, through the test family ``tiny_interleaved``
CONFIGS["tiny-interleaved"] = {
    "name": "tiny-interleaved", "family": "tiny_interleaved", "arch": "mixtral-8x22b",
    "hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 4, "num_experts": 4,
    "num_experts_per_tok": 2, "expert_layer_period": 2, "expert_layer_offset": 1,
    "vocab_size": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "float32", "capacity_factor": 1.0}
CONFIGS["tiny-dense-bf16"] = dict(CONFIGS["tiny-dense"], name="tiny-dense-bf16",
                                  torch_dtype="bfloat16", hidden_size=256,
                                  intermediate_size=512, num_hidden_layers=4)
MIX = {"name": "tiny", "prompts_per_wire": 2,
       "prompt_len": {"dist": "loguniform", "lo": 3, "hi": 16}, "pad_to": 16, "max_new": 5}
LONG_MIX = dict(MIX, name="tiny-long", pad_to=128, max_new=3,
                prompt_len={"dist": "uniform", "lo": 3, "hi": 128})
_E2E = ["tokens_per_s", "setup_s"]
WORKLOADS = {
    "tiny-dense.batched": {"config": "tiny-dense", "plane": "batched", "wires_per_call": 3,
                           "slots": 4, "plane_args": {}, "end_to_end": _E2E,
                           "per_layer": ["decode_step_ms", "step_mfu", "device_idle_share"]},
    "tiny-dense.stream": {"config": "tiny-dense", "plane": "stream", "wires_per_call": 3,
                          "slots": 2, "plane_args": {"n_shards": 2, "overlap": True,
                                                     "logprobs": True},
                          "end_to_end": ["tokens_per_s", "ttft_p95_s", "itl_p95_ms",
                                         "setup_s"],
                          "per_layer": ["decode_step_ms", "admit_wait_ticks", "serve_tick_ms",
                                        "fabric_tick_ms", "device_idle_share"]},
    "tiny-moe.batched": {"config": "tiny-moe", "plane": "batched", "wires_per_call": 4,
                         "slots": 8, "plane_args": {}, "end_to_end": _E2E,
                         "per_layer": ["decode_step_ms", "moe_device_share"]},
    # the MoE cells' statistics over one whole call's sequences: the median
    # and the third largest of each sequence's mean gap
    "tiny-moe.median": {"config": "tiny-moe", "plane": "batched", "wires_per_call": 4,
                        "slots": 8, "plane_args": {}, "end_to_end": _E2E,
                        "per_layer": ["decode_step_ms"],
                        "stats": ["logit_gap_seq_median", "logit_gap_seq_third"]},
    # 128 x 128 prefill tokens: two MoE groups of 8192, as the program forms them
    "tiny-moe.grouped": {"config": "tiny-moe", "traffic": "tiny-long", "plane": "batched",
                         "wires_per_call": 64, "slots": 128, "plane_args": {},
                         "end_to_end": _E2E, "per_layer": ["decode_step_ms"]},
    "tiny-interleaved.batched": {"config": "tiny-interleaved", "plane": "batched",
                                 "wires_per_call": 4, "slots": 8, "plane_args": {},
                                 "end_to_end": _E2E,
                                 "per_layer": ["decode_step_ms", "moe_device_share"]},
    "tiny-dense-bf16.batched": {"config": "tiny-dense-bf16", "plane": "batched",
                                "wires_per_call": 3, "slots": 6, "plane_args": {},
                                "end_to_end": _E2E, "per_layer": ["decode_step_ms"],
                                "logit_gap": 0.015},
}


#: the test family's source; a test tree holds it as ``families/<name>.py``
FAMILY = Path(__file__).with_name("tiny_interleaved.py")


def copy_bench(tmp: Path) -> Path:
    """A copy of the benchmark's files that ``cells.load`` finds by name:
    planes, metrics, mixes, configurations, cells, and the families where
    any ship."""
    root = tmp / "bench"
    for d in ("planes", "metrics", "end_to_end", "traffic", "configs", "workloads"):
        shutil.copytree(BENCH / d, root / d)
    if (BENCH / "families").is_dir():
        shutil.copytree(BENCH / "families", root / "families")
    return root


def make_tree(tmp: Path) -> Path:
    """``copy_bench``'s tree plus the tiny files and the test family."""
    root = copy_bench(tmp)
    (root / "families").mkdir(exist_ok=True)
    shutil.copy(FAMILY, root / "families" / FAMILY.name)
    for name, cfg in CONFIGS.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for mix in (MIX, LONG_MIX):
        (root / "traffic" / f"{mix['name']}.json").write_text(json.dumps(mix))
    for name, w in WORKLOADS.items():
        limit = w.pop("logit_gap", 1e-3)
        check = dict({s: limit for s in w.pop("stats", ["logit_gap"])}, sample=4)
        w = dict({"traffic": "tiny"}, **w, name=name, chips=1, why="a CPU test", check=check)
        (root / "workloads" / f"{name}.json").write_text(json.dumps(w))
    return root


def run(root: Path, name: str, seed: int = 5, trace: bool = False, control: bool = False,
        seconds: float = 0.0) -> dict:
    from hgum_bench import cells
    from hgum_bench.harness import run_cell

    return run_cell(cells.load(name, root), seed, seconds, trace, time.perf_counter(),
                    device="cpu", control=control)
