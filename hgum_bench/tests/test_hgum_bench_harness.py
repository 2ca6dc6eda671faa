"""The harness end to end on the CPU at tiny sizes: sound runs are correct,
the reference equals the program, and every fault the cells can have,
and the float8 control, come out not correct."""
from __future__ import annotations

import json
from unittest import mock

import pytest
import torch

from hgum_bench.harness import program_config, program_params
from hgum_bench.reference import model as ref_model
from hgum_bench.reference import weights

from .tiny import CONFIGS, make_tree, run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("hgum_bench"))


@pytest.mark.parametrize("name,trace", [
    ("tiny-dense.batched", False), ("tiny-dense.batched", True),
    ("tiny-dense.stream", False), ("tiny-dense.stream", True),
    ("tiny-moe.batched", False), ("tiny-moe.batched", True), ("tiny-moe.grouped", False),
    ("tiny-moe.median", False),
])
def test_sound_run_is_correct(root, name, trace):
    out = run(root, name, seed=2 ** 31 + 11, trace=trace, seconds=0.2)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         *(["breakdown"] if trace else []), "checks"]
    cell = json.loads((root / "workloads" / f"{name}.json").read_text())
    want = cell["per_layer"] if trace else cell["end_to_end"]
    # device-trace metrics read nothing on the CPU; every other one is there
    cpu_less = {"step_mfu", "device_idle_share", "moe_device_share"}
    assert set(out["metrics"]) == set(want) - cpu_less
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    if trace:
        assert out["device"]["window_s"] > 0
        assert len(out["breakdown"]["idle_gaps"]) <= 10


def _forward_pair(cfg_json, seed=3, B=3, L=12):
    W = weights.make(cfg_json, seed, "cpu")
    cfg = program_config(cfg_json)
    params = program_params(cfg, W)
    toks = torch.randint(2, cfg_json["vocab_size"], (B, L), generator=torch.Generator().manual_seed(1))
    from repro_torch.models.model import forward

    with torch.no_grad():
        port, _, aux = forward(params, cfg, {"tokens": toks.to(torch.int32)})
    return W, toks, port, aux


def test_reference_equals_the_program_dense():
    cfg = CONFIGS["tiny-dense"]
    W, toks, port, _ = _forward_pair(cfg)
    ref = ref_model.forward(W, cfg, toks, 0)
    torch.testing.assert_close(ref, port[..., :cfg["vocab_size"]], rtol=1e-4, atol=1e-4)


def test_reference_equals_the_program_moe_with_drops():
    cfg = dict(CONFIGS["tiny-moe"], capacity_factor=0.5)
    W, toks, port, aux = _forward_pair(cfg)
    assert float(aux["moe_dropped"]) > 0  # the capacity rule is exercised
    m = weights.dims(cfg)
    n = toks.numel()
    groups = [(torch.arange(n), ref_model.moe_capacity(n, m["E"], m["k"], m["cf"]))]
    ref = ref_model.forward(W, cfg, toks, 0, groups)
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-4)
    dropless = ref_model.forward(W, cfg, toks, 0, [(torch.arange(n), n * m["k"])])
    assert (dropless - port).abs().max() > 1e-2


def test_moe_groups_follow_the_program_batches():
    from hgum_bench.reference.check import moe_groups

    dm = weights.dims(json.loads(json.dumps(CONFIGS["tiny-moe"])))
    groups = moe_groups(64, 64, 1024, 128, dict(dm, E=8, k=2, cf=1.25), "cpu")
    assert len(groups) == 8 + 127
    assert [c for _, c in groups[:8]] == [2560] * 8 and groups[8][1] == 24
    L = 1024 + 127
    assert groups[0][0][:3].tolist() == [0, 1, 2] and groups[0][0][1024].item() == L
    assert groups[8][0][:2].tolist() == [1024, L + 1024]
    covered = torch.cat([g for g, _ in groups]).sort().values
    assert torch.equal(covered.unique(), covered)  # each token in one group
    with pytest.raises(ValueError):
        moe_groups(60, 64, 1024, 128, dm, "cpu")


def _repeat_state(orig):
    """The decode step hands back the tokens and cache it was given."""
    def patched(*a, **k):
        prefill, decode = orig(*a, **k)

        def stuck(params, cache, tok):
            out = decode(params, cache, tok)
            return (tok,) + tuple(out[1:-1]) + (cache,)
        return prefill, stuck
    return patched


FAULTY = ["tiny-dense.batched", "tiny-dense.stream", "tiny-moe.batched", "tiny-moe.median"]


def _failed_gap(out) -> bool:
    return any(c["value"] > c["limit"] for k, c in out["checks"].items()
               if k.startswith("logit_gap"))


@pytest.mark.parametrize("name", FAULTY)
def test_fault_step_returns_its_state_unchanged(root, name):
    import repro_torch.launch.steps as steps

    with mock.patch.object(steps, "cached_serve_steps", _repeat_state(steps.cached_serve_steps)):
        out = run(root, name, seed=21)
    assert not out["correct"] and _failed_gap(out)


@pytest.mark.parametrize("name", FAULTY)
def test_fault_half_the_batch_left_out(root, name):
    import repro_torch.launch.serve as serve

    fn = "serve_requests_streaming" if "stream" in name else "serve_requests"
    orig = getattr(serve, fn)

    def half(params, cfg, wires, **kw):
        out = orig(params, cfg, wires[: max(1, len(wires) // 2)], **kw)
        return out + out[: len(wires) - len(out)]
    with mock.patch.object(serve, fn, half):
        out = run(root, name, seed=22)
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["bad_wires"]["value"] > 0


@pytest.mark.parametrize("name", FAULTY)
def test_fault_half_the_slots_decoded_wrong(root, name):
    """The decode step hands back, for the first half of its slots, the
    tokens it was given; the other half is served right."""
    import repro_torch.launch.steps as steps

    orig = steps.cached_serve_steps

    def patched(*a, **k):
        prefill, decode = orig(*a, **k)

        def half_stuck(params, cache, tok):
            out = decode(params, cache, tok)
            nxt = out[0].clone()
            h = nxt.shape[0] // 2
            nxt[:h] = tok.reshape(nxt.shape)[:h]
            return (nxt,) + tuple(out[1:])
        return prefill, half_stuck
    with mock.patch.object(steps, "cached_serve_steps", patched):
        out = run(root, name, seed=24)
    assert not out["correct"] and _failed_gap(out)
    if name == "tiny-moe.median":
        # the median over the call's sequences stays with the sound half;
        # the third largest sequence mean sees the faulty one
        checks = out["checks"]
        assert checks["logit_gap_seq_median"]["value"] <= checks["logit_gap_seq_median"]["limit"]
        assert checks["logit_gap_seq_third"]["value"] > checks["logit_gap_seq_third"]["limit"]


@pytest.mark.parametrize("name", FAULTY)
def test_fault_token_altered_where_produced(root, name):
    from repro_torch.runtime.scheduler import ContinuousBatcher

    orig = ContinuousBatcher.step_finish

    def altered(self):
        """Every sequence's token at position 1 is off by one as the
        scheduler records and emits it."""
        out = []
        for sid, pos, tok in orig(self):
            if pos == 1:
                tok = (tok + 1) % self.cfg.vocab
                seqs = [s.out for s in self.active if s is not None and s.seq_id == sid]
                (seqs[0] if seqs else self.done[sid])[pos] = tok
            out.append((sid, pos, tok))
        return out
    with mock.patch.object(ContinuousBatcher, "step_finish", altered):
        out = run(root, name, seed=23)
    assert not out["correct"] and _failed_gap(out)


def test_control_fails_the_limit(root):
    """The float8 reference in the program's place fails the limit that a
    sound bfloat16 run of the same cell meets."""
    out = run(root, "tiny-dense-bf16.batched", seed=31, control=True)
    limit = out["checks"]["logit_gap"]["limit"]
    assert out["correct"] and out["checks"]["logit_gap"]["value"] <= limit
    assert out["readings"]["control"]["max"] > limit
    assert out["readings"]["program"]["max"] == out["checks"]["logit_gap"]["value"]
