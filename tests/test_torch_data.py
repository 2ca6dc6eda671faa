"""Port parity, the data plane: ``repro_torch.data`` (the HGum Batch
pipeline, its decode through the DES kernels' plain versions, the
prefetcher and the straggler watchdog) against the JAX package.

The host half (``SyntheticCorpus``, ``pack_documents``,
``serialize_batch``, ``batch_plan``) is numpy in both packages: wires and
plans must be byte-equal.  The reference's own ``decode_batch`` dies in
``pl.load`` on this JAX (ROADMAP.md queue C), so the port's decode is
held bit for bit to the reference's ``core.vectorized.decode_message``
and to the packed arrays themselves, and ``finalize_batch`` to the
reference's (a plain ``jnp`` function).  No test sleeps: the watchdog
runs on a patched clock.
"""
import itertools
import queue
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core.vectorized import decode_message as j_decode_message
from repro.core.vectorized import plan_from_wire as j_plan_from_wire
from repro.core.vectorized import wire_to_u8
from repro.data import HGumBatchPipeline as JPipeline
from repro.data.pipeline import batch_plan as j_batch_plan
from repro.data.pipeline import finalize_batch as j_finalize_batch
from repro.data.schemas import batch_schema as j_batch_schema
from repro_torch.core import ser_sw_to_hw
from repro_torch.data import HGumBatchPipeline, Prefetcher, SyntheticCorpus, pack_documents
from repro_torch.data import prefetch as tprefetch
from repro_torch.data.pipeline import batch_plan, decode_batch, finalize_batch, serialize_batch
from repro_torch.data.schemas import batch_schema
from repro_torch.device import NoCudaError
from repro_torch.kernels import ops
import torch_parity  # noqa: F401 (process setup: a share of the cores, TF32 off)

PATHS = ["rows.elem.tokens.elem", "rows.elem.segids.elem"]


@pytest.mark.parametrize("batch,seq", [(1, 16), (2, 32), (4, 24)])
def test_wires_match_reference(batch, seq):
    """The same seed makes the same wires, step after step."""
    ref = JPipeline(vocab=512, batch=batch, seq=seq, seed=7)
    port = HGumBatchPipeline(vocab=512, batch=batch, seq=seq, seed=7, device="cpu")
    for _ in range(3):
        assert port.host_make_wire() == ref.host_make_wire()


def test_bulk_ser_equals_ser_sw_to_hw():
    tokens, segids = pack_documents(SyntheticCorpus(512, seed=3, mean_len=8).docs(), 3, 20)
    msg = {"rows": [{"tokens": list(map(int, tokens[b])), "segids": list(map(int, segids[b]))}
                    for b in range(3)]}
    assert serialize_batch(tokens, segids) == ser_sw_to_hw(batch_schema(20), msg)


@pytest.mark.parametrize("batch,seq", [(1, 8), (3, 16)])
def test_batch_plan_matches_reference(batch, seq):
    got, want = batch_plan(batch, seq), j_batch_plan(batch, seq)
    assert got.counts == want.counts and got.nbytes == want.nbytes
    assert got.is_container == want.is_container and got.wire_len == want.wire_len
    assert list(got.offsets) == list(want.offsets)
    for k in want.offsets:
        assert got.offsets[k].dtype == want.offsets[k].dtype
        np.testing.assert_array_equal(got.offsets[k], want.offsets[k])
    wire = serialize_batch(*pack_documents(SyntheticCorpus(99, seed=1).docs(), batch, seq))
    p2 = j_plan_from_wire(j_batch_schema(seq), wire)
    for k in p2.offsets:
        np.testing.assert_array_equal(got.offsets[k][:p2.counts[k]], p2.offsets[k][:p2.counts[k]])


@pytest.mark.parametrize("batch,seq", [(1, 32), (2, 32), (4, 64)])
def test_decode_batch_bit_equal(batch, seq):
    """decode_batch on the host (the plain DES) == the reference's
    ``decode_message`` == the packed arrays, bit for bit; a wire of two or
    more rows takes the gather route for both leaves, one row the run
    route; every other field is ``finalize_batch``'s."""
    tokens, segids = pack_documents(SyntheticCorpus(50000, seed=batch).docs(), batch, seq)
    wire = serialize_batch(tokens, segids)
    got = decode_batch(wire, batch, seq, device="cpu")
    ref = j_decode_message(wire_to_u8(wire), j_batch_plan(batch, seq), PATHS)
    for name, path, arr in (("tokens", PATHS[0], tokens), ("segment_ids", PATHS[1], segids)):
        assert got[name].dtype == torch.int32 and tuple(got[name].shape) == (batch, seq)
        np.testing.assert_array_equal(got[name].numpy(), arr.astype(np.int32))
        np.testing.assert_array_equal(got[name].numpy().reshape(-1),
                                      np.asarray(ref[path])[:, 0].astype(np.int32))
        route = ops.runs_from_plan(batch_plan(batch, seq), path)
        assert (route is None) == (batch >= 2)
    want = finalize_batch(got["tokens"], got["segment_ids"])
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 11])
def test_finalize_batch_matches_reference(seed):
    tokens, segids = pack_documents(SyntheticCorpus(512, seed=seed, mean_len=8).docs(), 3, 40)
    t, s = tokens.astype(np.int32), segids.astype(np.int32)
    got = finalize_batch(torch.from_numpy(t), torch.from_numpy(s))
    want = j_finalize_batch(jnp.asarray(t), jnp.asarray(s))
    assert set(got) == set(want)
    for k in want:
        assert str(got[k].dtype)[len("torch."):] == str(want[k].dtype), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    pos, seg = got["positions"].numpy(), s
    for b in range(3):
        for i in range(1, 40):
            assert pos[b, i] == (0 if seg[b, i] != seg[b, i - 1] else pos[b, i - 1] + 1)
    assert got["loss_mask"][:, -1].sum() == 0


def test_pipeline_iterates_on_the_host():
    pipe = HGumBatchPipeline(vocab=256, batch=2, seq=32, seed=0, device="cpu")
    b1, b2 = next(pipe), next(pipe)
    assert b1["tokens"].shape == (2, 32) and b1["tokens"].device.type == "cpu"
    assert not torch.equal(b1["tokens"], b2["tokens"])


def test_pipeline_and_decode_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    wire = serialize_batch(*pack_documents(SyntheticCorpus(99, seed=1).docs(), 2, 8))
    for call in (lambda: HGumBatchPipeline(vocab=99, batch=2, seq=8),
                 lambda: decode_batch(wire, 2, 8)):
        with pytest.raises(NoCudaError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# prefetcher and watchdog
# ---------------------------------------------------------------------------


def test_prefetcher_orders_and_closes():
    c = itertools.count()
    pf = Prefetcher(lambda: next(c), depth=3)
    vals = [pf.get() for _ in range(8)]
    pf.close()
    assert vals == list(range(8))
    assert not pf.thread.is_alive()


def test_prefetcher_surfaces_errors():
    def boom():
        raise RuntimeError("producer died")

    pf = Prefetcher(boom, depth=1)
    pf.thread.join(timeout=5.0)
    assert not pf.thread.is_alive()
    with pytest.raises(RuntimeError, match="producer died"):
        pf.get(timeout=2)
    pf.close()


def test_prefetcher_get_times_out_when_empty():
    go, c = threading.Event(), itertools.count()
    pf = Prefetcher(lambda: (go.wait(), next(c))[1], depth=1)
    with pytest.raises(queue.Empty):
        pf.get(timeout=0.05)
    go.set()
    assert pf.get(timeout=5) == 0
    pf.close()
    assert not pf.thread.is_alive()


def test_prefetcher_builds_wires_of_the_pipeline():
    pipe = HGumBatchPipeline(vocab=512, batch=2, seq=16, seed=4, device="cpu")
    ref = JPipeline(vocab=512, batch=2, seq=16, seed=4)
    pf = Prefetcher(pipe.host_make_wire, depth=2)
    try:
        got = [pf.get() for _ in range(4)]
    finally:
        pf.close()
    assert got == [ref.host_make_wire() for _ in range(4)]


def test_straggler_watchdog_on_a_patched_clock(monkeypatch):
    """Steps of 2 ms, then one of 50 ms: only the slow one is flagged, and
    only once 8 steps give a median (the reference's test, without its
    sleeps)."""
    now = [0.0]
    monkeypatch.setattr(tprefetch.time, "monotonic", lambda: now[0])
    dog = tprefetch.StragglerWatchdog(threshold=3.0)
    for i in range(10):
        dog.start()
        now[0] += 0.002 if i else 0.05  # a slow first step has no median yet
        assert dog.stop() is False
    dog.start()
    now[0] += 0.05
    assert dog.stop() is True
    assert dog.flagged == 1
    dog.start()
    now[0] += 0.0059  # under 3x the trailing median
    assert dog.stop() is False
    assert dog.flagged == 1
