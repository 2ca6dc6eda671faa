"""Port parity, routed fabric: ``repro_torch.fabric`` against the JAX package.

The JAX fabric runs on the 8 fake CPU devices ``tests/conftest.py`` sets
up; the port's fabric runs its ranks as a tensor axis on the CPU.  Both get
the same seeded sends (numpy), and every delivery (wire bytes, ``ok``,
ListLevel, ``arrive_step``, the attribution vector, the first seq) and the
all-time counter block must be bit-identical, on both tick engines, in
every configuration below.  The frame kernels' plain versions are held to
the Pallas ``pack_frames_batch`` / ``unpack_frames_batch`` in interpret
mode; the CUDA kernels themselves are held to their plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import zlib
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.fabric import Fabric as JFabric
from repro.fabric import FabricConfig as JConfig
from repro.fabric import FaultPlan as JFaultPlan
from repro.fabric import frames as jframes
from repro.kernels import frame_pack as jpack
from repro_torch.core import lanes_u32
from repro_torch.fabric import Fabric, FabricConfig, FaultPlan, frames
from repro_torch.kernels import frame_pack as tpack
from repro_torch.kernels import ops


def _lanes(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# wire format: CRC32, route words, framing
# ---------------------------------------------------------------------------


def test_crc32_matches_zlib_and_jax():
    rng = np.random.default_rng(0)
    words = _u32(rng, (6, 37))
    got = lanes_u32(frames.crc32_words(_lanes(words)))
    assert list(got) == [zlib.crc32(r.tobytes()) for r in words]
    assert int(got[0]) == int(jframes.crc32_words(jnp.asarray(words[0])))
    # one word, and a reorder the additive checksum would miss
    assert lanes_u32(frames.crc32_words(_lanes(words[:, :1])))[2] == zlib.crc32(words[2, :1])
    a = frames.crc32_words(_lanes(np.array([1, 2], np.uint32)))
    b = frames.crc32_words(_lanes(np.array([2, 1], np.uint32)))
    assert int(a) != int(b)


def test_route_words_match_jax():
    src, dst, seq = np.array([0, 5, 127, 3]), np.array([7, 0, 255, 128]), np.array([0, 1, 65535, 9])
    for adaptive in (False, True):
        got = lanes_u32(frames.pack_route(src, dst, seq, adaptive=adaptive))
        want = np.asarray(jframes.pack_route(src, dst, seq, adaptive=adaptive))
        np.testing.assert_array_equal(got, want)
        fr = np.zeros((4, 6), np.uint32)
        fr[:, 3] = want
        t = _lanes(fr)
        for mine, ref in ((frames.route_src, jframes.route_src), (frames.route_dst, jframes.route_dst),
                          (frames.route_seq, jframes.route_seq),
                          (frames.route_adaptive, jframes.route_adaptive)):
            np.testing.assert_array_equal(mine(t).numpy(), np.asarray(ref(jnp.asarray(fr))))
        for mine, ref in zip(frames.unpack_route(_lanes(want)), jframes.unpack_route(want)):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    # the adaptive bit makes the int32 carrier negative
    assert int(frames.pack_route(1, 2, 3, adaptive=True)) < 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_frame_parts_batch_and_verify_match_jax(adaptive):
    rng = np.random.default_rng(1)
    B, cap, phits = 5, 24, 2
    payloads = _u32(rng, (B, cap))
    nbytes = np.array([0, 5, 40, 96, 64], np.int32)
    routes = np.stack([np.arange(B), (np.arange(B) + 3) % 8, np.arange(B) * 65530 % 65536],
                      axis=1).astype(np.int32)
    levels = np.array([1, 2, 255, 0, 7], np.uint32)
    got = frames.frame_parts_batch(_lanes(payloads), nbytes, routes, list_level=levels,
                                   frame_phits=phits, adaptive=adaptive)
    want = jframes.frame_parts_batch(jnp.asarray(payloads), jnp.asarray(nbytes),
                                     jnp.asarray(routes), list_level=jnp.asarray(levels),
                                     frame_phits=phits, adaptive=adaptive)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(lanes_u32(g), np.asarray(w))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    fr = np.concatenate([np.asarray(want[0]), np.asarray(want[1])], axis=-1)
    fr[1, 0, 6] ^= 1 << 9  # payload bit flip
    fr[3, 1, 1] ^= 1  # header (level) bit flip
    np.testing.assert_array_equal(frames.verify_frames(_lanes(fr)).numpy(),
                                  np.asarray(jframes.verify_frames(jnp.asarray(fr))))
    # single-stream framing and unframing
    f1, n1 = frames.frame_stream(_lanes(payloads[2]), 40, list_level=3, frame_phits=phits,
                                 route=(1, 2, 65535), adaptive=adaptive)
    jf1, jn1 = jframes.frame_stream(jnp.asarray(payloads[2]), jnp.asarray(40), list_level=3,
                                    frame_phits=phits, route=(1, 2, 65535), adaptive=adaptive)
    np.testing.assert_array_equal(lanes_u32(f1), np.asarray(jf1))
    assert int(n1) == int(jn1)
    for g, w in zip(frames.unframe_stream(f1), jframes.unframe_stream(jf1)):
        np.testing.assert_array_equal(lanes_u32(g) if g.dtype == torch.int32 else g.numpy(),
                                      np.asarray(w))
    assert frames.frame_capacity(40, phits) == jframes.frame_capacity(40, phits)


# ---------------------------------------------------------------------------
# B5 / B6 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,F,fw", [(1, 1, 4), (3, 2, 8), (5, 3, 64)])
def test_frame_kernels_plain_match_pallas(B, F, fw):
    rng = np.random.default_rng(B * 100 + fw)
    hdr, pay = _u32(rng, (B, F, 4)), _u32(rng, (B, F, fw))
    got = tpack.pack_frames_batch(_lanes(hdr), _lanes(pay))
    want = np.asarray(jpack.pack_frames_batch(jnp.asarray(hdr), jnp.asarray(pay)))
    np.testing.assert_array_equal(lanes_u32(got), want)
    flat = want.reshape(-1, want.shape[-1])
    gh, gp = tpack.unpack_frames_batch(_lanes(flat))
    wh, wp = jpack.unpack_frames_batch(jnp.asarray(flat))
    np.testing.assert_array_equal(lanes_u32(gh), np.asarray(wh))
    np.testing.assert_array_equal(lanes_u32(gp), np.asarray(wp))


@pytest.mark.parametrize("N,fw", [(1, 1), (9, 3), (17, 5)])
def test_unpack_frames_plain_matches_pallas(N, fw):
    """B6's CPU route against the Pallas split in interpret mode at widths
    that are not whole phits (the card's word form; whole phits are held
    above); both outputs contiguous."""
    rng = np.random.default_rng(N * 1000 + fw)
    flat = _u32(rng, (N, 4 + fw))
    gh, gp = tpack.unpack_frames_batch(_lanes(flat))
    wh, wp = jpack.unpack_frames_batch(jnp.asarray(flat))
    assert gh.is_contiguous() and gp.is_contiguous()
    np.testing.assert_array_equal(lanes_u32(gh), np.asarray(wh))
    np.testing.assert_array_equal(lanes_u32(gp), np.asarray(wp))


def test_encode_decode_frames_batch_match_jax():
    from repro.kernels import ops as jops

    rng = np.random.default_rng(2)
    B, cap = 4, 32
    payloads = _u32(rng, (B, cap))
    nbytes = np.array([1, 64, 128, 17], np.int32)
    routes = np.array([[0, 1, 0], [2, 7, 100], [5, 5, 65535], [7, 0, 3]], np.int32)
    got, gn = ops.encode_frames_batch(_lanes(payloads), nbytes, routes, list_level=2,
                                      frame_phits=2, adaptive=True)
    want, wn = jops.encode_frames_batch(jnp.asarray(payloads), jnp.asarray(nbytes),
                                        jnp.asarray(routes), list_level=2, frame_phits=2,
                                        adaptive=True)
    np.testing.assert_array_equal(lanes_u32(got), np.asarray(want))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    flat = got.reshape(-1, got.shape[-1])
    for g, w in zip(ops.decode_frames_batch(flat),
                    jops.decode_frames_batch(jnp.asarray(lanes_u32(flat)))):
        np.testing.assert_array_equal(lanes_u32(g), np.asarray(w))


@pytest.mark.parametrize("nbytes", [[0, 1, 3, 4], [32, 33, 95, 96], [97, 128, 129, 4000]],
                         ids=["short", "edges", "over-cap"])
def test_encode_frames_batch_n_frames_match_jax(nbytes):
    """``n_frames`` as the reference counts it (the frames holding payload,
    plus the terminator), also for byte counts past the payload cap of 96
    bytes, where it is F + 1; the frames stay equal too."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(len(nbytes) + sum(nbytes))
    payloads = _u32(rng, (4, 24))
    nbytes = np.array(nbytes, np.int32)
    routes = np.array([[0, 1, 0], [2, 7, 100], [5, 5, 65535], [7, 0, 3]], np.int32)
    got, gn = ops.encode_frames_batch(_lanes(payloads), nbytes, routes, frame_phits=2)
    want, wn = jops.encode_frames_batch(jnp.asarray(payloads), jnp.asarray(nbytes),
                                        jnp.asarray(routes), frame_phits=2)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_array_equal(lanes_u32(got), np.asarray(want))


# frame_batch (B5 with the headers built in the launch): its plain version
# against the JAX structure pass + the Pallas join; cases by stream
_FB_CASES = {
    # name: (nbytes per stream, frame_phits, cap words)
    "empty-and-short": ([0, 1, 3, 4, 8], 2, 24),
    "frame-edges": ([32, 33, 31, 64, 65], 2, 24),  # one frame exactly, one byte over
    "full-and-over-cap": ([96, 95, 97, 2, 5], 2, 24),
    "wide-frames": ([0, 257, 1024, 1, 700], 16, 256),
}


@pytest.mark.parametrize("adaptive", [False, True], ids=["shortest", "adaptive"])
@pytest.mark.parametrize("case", sorted(_FB_CASES))
def test_frame_batch_plain_matches_jax_and_pallas(case, adaptive):
    """Sizes, per-stream levels, CRCs and route words (src and dst at their
    field widths, seq0 within F of 2**16 so the sequence wraps) equal the
    JAX ``frame_parts_batch`` joined by the Pallas ``pack_frames_batch``."""
    nbytes, phits, cap = _FB_CASES[case]
    nbytes = np.array(nbytes, np.int32)
    B = len(nbytes)
    rng = np.random.default_rng(sum(nbytes) + phits)
    payloads = _u32(rng, (B, cap))
    routes = np.array([[0, 255, 65534], [127, 0, 65535], [5, 200, 65533], [126, 1, 0],
                       [64, 128, 65530]], np.int32)[:B]
    levels = np.array([1, 2, 255, 0, 7], np.uint32)[:B]
    got = tpack.frame_batch(_lanes(payloads), nbytes, routes, torch.from_numpy(
        levels.astype(np.int64)), phits, adaptive)
    hdr, data, _ = jframes.frame_parts_batch(
        jnp.asarray(payloads), jnp.asarray(nbytes), jnp.asarray(routes),
        list_level=jnp.asarray(levels), frame_phits=phits, adaptive=adaptive)
    want = np.asarray(jpack.pack_frames_batch(hdr, data))
    np.testing.assert_array_equal(lanes_u32(got), want)
    assert got.shape == (B, -(-cap // (4 * phits)) + 1, 4 + 4 * phits)
    # the seq wraps within the stream: seq0 = 65535 -> 65535, 0, 1, ...
    seqs = frames.route_seq(got[1]).numpy()
    assert list(seqs[:3]) == [65535, 0, 1]
    assert bool(frames.verify_frames(got).all())


@pytest.mark.parametrize("phits", [1, 2, 3, 4, 5, 16, 37, 500])
def test_frame_batch_crc_tables_give_zlib(phits):
    """The tables the frame_batch kernel reads, used as the kernel uses them
    (zero-initialised CRC of 4 equal runs of phits, front-padded with zero
    phits, joined pairwise by the shift tables, then ``crc_xor``), give
    ``zlib.crc32`` of the frame's message."""
    lanes = 4
    blob, crc_xor = tpack.crc_tables(phits)
    assert blob.shape == (3 * 1024,) and blob.dtype == np.uint32

    def lookup4(t, x):
        return int(t[x & 0xFF] ^ t[256 + ((x >> 8) & 0xFF)] ^ t[512 + ((x >> 16) & 0xFF)]
                   ^ t[768 + (x >> 24)])

    rng = np.random.default_rng(phits * 10 + lanes)
    for _ in range(3):
        words = _u32(rng, (3 + 4 * phits,))
        phit_rows = [np.r_[np.uint32(0), words[:3]]] + list(words[3:].reshape(phits, 4))
        S = (phits + lanes) // lanes
        pad = lanes * S - (phits + 1)
        crcs = []
        for lane in range(lanes):
            c = 0
            for q in range(max(lane * S, pad), (lane + 1) * S):
                for w in phit_rows[q - pad]:
                    c = lookup4(blob, int(w) ^ c)
            crcs.append(c)
        for k in range(lanes.bit_length() - 1):
            t, d = blob[1024 * (1 + k):1024 * (2 + k)], 1 << k
            crcs = [lookup4(t, crcs[i]) ^ crcs[i + d] if i + d < lanes else crcs[i]
                    for i in range(lanes)]
        assert crcs[0] ^ crc_xor == zlib.crc32(words.tobytes())


def test_frame_batch_rejects_bad_operands():
    with pytest.raises(ValueError, match=r"\(B, Wcap\) int32"):
        tpack.frame_batch(torch.zeros(2, 8, dtype=torch.int64), [1, 2], [[0, 1, 0]] * 2,
                          1, 2)
    with pytest.raises(ValueError, match="frame_phits"):
        tpack.frame_batch(torch.zeros(2, 8, dtype=torch.int32), [1, 2], [[0, 1, 0]] * 2,
                          1, 0)
    meta = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpack.frame_batch(meta, [1, 2], [[0, 1, 0]] * 2, 1, 2)


def test_frame_batch_cuda_tensor_never_takes_plain(monkeypatch):
    """A CUDA tensor reaches the launch (which cannot allocate here) and
    never the plain version."""
    monkeypatch.setattr(tpack, "frame_batch_plain",
                        lambda *a, **k: pytest.fail("plain version for a CUDA tensor"))
    fake = mock.MagicMock(spec=torch.Tensor)
    fake.dtype, fake.device, fake.shape, fake.is_cuda = (
        torch.int32, torch.device("cuda", 0), (2, 8), True)
    fake.dim.return_value = 2
    with pytest.raises((RuntimeError, AssertionError)):  # no CUDA in this torch
        tpack.frame_batch(fake, [1, 2], [[0, 1, 0]] * 2, 1, 2)


def test_frame_kernel_wrappers_reject_bad_operands():
    with pytest.raises(ValueError, match="pair up"):
        tpack.pack_frames_batch(torch.zeros(2, 3, dtype=torch.int32),
                                torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32 lanes"):
        tpack.unpack_frames_batch(torch.zeros(2, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(N, 4 \+ frame_words\)"):
        tpack.unpack_frames_batch(torch.zeros(2, 3, 8, dtype=torch.int32))


def test_frame_pack_recording_and_cpu_counts():
    """On the CPU the wrappers take the plain versions: nothing launches,
    nothing is recorded."""
    tpack.reset_launches()
    with tpack.recording() as made:
        ops.encode_frames_batch(torch.zeros(2, 8, dtype=torch.int32), [4, 8],
                                [[0, 1, 0], [1, 0, 0]], frame_phits=2)
        tpack.frame_batch(torch.zeros(2, 8, dtype=torch.int32), [4, 8],
                          [[0, 1, 0], [1, 0, 0]], [1, 1], 2)
        frames.frame_stream(torch.zeros(8, dtype=torch.int32), 8, frame_phits=2)
        ops.encode_chunks_batch(torch.zeros(2, 3, dtype=torch.int32),
                                torch.zeros(2, 4, dtype=torch.int32),
                                torch.ones(2, dtype=torch.int32))
        ops.encode_run(torch.ones(2, 2, dtype=torch.int32), 8, 7)
        ops.write_headers(torch.zeros(8, dtype=torch.int32),
                          torch.tensor([[2, 5, 1]], dtype=torch.int32))
        ops.encode_chunks_trimmed(torch.zeros(2, 3, dtype=torch.int32),
                                  torch.zeros(2, 4, dtype=torch.int32),
                                  torch.ones(2, dtype=torch.int32),
                                  torch.tensor([1, 2], dtype=torch.int32),
                                  torch.tensor([0, 5]), 11)
    assert made == [] and tpack.LAUNCHES == {"pack_run": 0,
                                             "stamp_headers": 0,
                                             "pack_frames_batch": 0,
                                             "frame_batch": 0,
                                             "unpack_frames_batch": 0,
                                             "pack_chunks_batch": 0,
                                             "chunk_bursts": 0}


# ---------------------------------------------------------------------------
# deliveries, attribution and counters against the JAX fabric
# ---------------------------------------------------------------------------


def _sends(rng, R, n, levels=(1,), max_len=90):
    out = []
    for _ in range(n):
        w = rng.integers(0, 256, int(rng.integers(1, max_len)), dtype=np.uint8).tobytes()
        out.append((int(rng.integers(R)), int(rng.integers(R)), w, int(rng.choice(levels))))
    return out


def _drain(fab, into):
    for r in range(fab.n_ranks):
        for d in fab.mailbox(r).recv():
            a = d.attribution
            into.append((r, d.src, d.wire, d.ok, d.list_level, d.arrive_step,
                         (a.enter_step, a.stall, a.wait, a.defections, a.transit), d.seq0))


def _run(fab, ticks, extra=0, until=None):
    """Send each tick's sends, exchange, drain; then ``extra`` idle ticks,
    or, with ``until``, idle ticks until that many messages arrived (at
    most 40).  Returns (deliveries, idle ticks run)."""
    got = []
    for sends in ticks:
        for s, d, w, lvl in sends:
            fab.send(s, d, w, lvl)
        fab.exchange()
        _drain(fab, got)
    idle = 0
    while idle < extra or (until is not None and len(got) < until and idle < 40):
        fab.exchange()
        _drain(fab, got)
        idle += 1
    return got, idle


def _jax_fabric(grid, kw, faults=None):
    if len(grid) == 1:
        fab = JFabric(n_ranks=grid[0], config=JConfig(**kw))
    else:
        fab = JFabric(mesh=jax.make_mesh(grid, ("fx", "fy")), config=JConfig(**kw))
    fab.faults = None if faults is None else JFaultPlan(**faults)
    return fab


def _port_fabric(grid, kw, faults=None):
    if len(grid) == 1:
        fab = Fabric(n_ranks=grid[0], config=FabricConfig(**kw), device="cpu")
    else:
        fab = Fabric(grid=grid, axis_names=("fx", "fy"), config=FabricConfig(**kw),
                     device="cpu")
    fab.faults = None if faults is None else FaultPlan(**faults)
    return fab


_ARQ = dict(frame_phits=2, credits=2, arq=True, retransmit_timeout=2, max_retries=8)
_CASES = {
    # name: (grid, config, levels, faults, ticks of sends)
    "fused": ((8,), dict(frame_phits=2, credits=2), (1, 2, 3), None, 2),
    "programs": ((8,), dict(frame_phits=2, credits=2, fused=False), (1, 2, 3), None, 2),
    "dimension": ((8,), dict(frame_phits=2, credits=2, routing="dimension"), (1,), None, 1),
    "dimension-programs": ((8,), dict(frame_phits=2, credits=2, routing="dimension",
                                      fused=False), (1,), None, 1),
    "grid-4x2": ((4, 2), dict(frame_phits=2, credits=2), (1,), None, 1),
    "grid-4x2-dimension-programs": ((4, 2), dict(frame_phits=2, credits=2, routing="dimension",
                                                 fused=False), (1,), None, 1),
    "credits1": ((8,), dict(frame_phits=1, credits=1), (1,), None, 1),
    "defect": ((8,), dict(frame_phits=1, credits=1, defect_after=2), (1,), None, 1),
    "qos": ((8,), dict(frame_phits=2, credits=3, qos_weights=(2, 1)), (1, 2, 3), None, 1),
    "qos-programs": ((8,), dict(frame_phits=2, credits=3, qos_weights=(2, 1), fused=False),
                     (1, 2, 3), None, 1),
    "arq-faults": ((4,), _ARQ, (1, 2), dict(seed=3, drop=0.1, corrupt=0.05, duplicate=0.05), 1),
    "arq-faults-programs": ((4,), dict(_ARQ, fused=False), (1, 2),
                            dict(seed=2, drop=0.05, corrupt=0.04, duplicate=0.1,
                                 reorder=0.5), 1),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_deliveries_and_counters_bit_identical(case):
    grid, kw, levels, faults, n_ticks = _CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    R = int(np.prod(grid))
    ticks = [_sends(rng, R, 8 if faults else 12, levels) for _ in range(n_ticks)]
    if case == "defect":  # a saturated 0 -> 1 link, so frames really defect
        ticks[0] += [(0, 1, bytes(range(200)), 1)] * 4
    n_sends = sum(map(len, ticks))
    jfab, tfab = _jax_fabric(grid, kw, faults), _port_fabric(grid, kw, faults)
    want, idle = _run(jfab, ticks, until=n_sends)
    got, _ = _run(tfab, ticks, extra=idle)
    assert len(want) == n_sends  # every message delivered
    assert got == want
    np.testing.assert_array_equal(tfab.counters_total(), jfab.counters_total())
    assert tfab.load_drift() == jfab.load_drift()
    assert tfab.ticks == jfab.ticks and tfab.frames_routed == jfab.frames_routed
    for r in range(R):
        assert tfab.class_arrive_stats(r) == jfab.class_arrive_stats(r)
    if case == "defect":
        from repro_torch.obs import counters_to_dict
        c = counters_to_dict(tfab.router.axis_names, tfab.counters_total().sum(0))
        assert c["link.defect_out{axis=fabric,dir=fwd}"] > 0
    if faults is not None:
        snap = {m["name"]: m["value"] for m in tfab.metrics.snapshot()["metrics"]
                if m["type"] == "counter" and m["name"].startswith("fabric.arq.")}
        assert snap["fabric.arq.retransmits"] > 0
        assert all(d[3] for d in got)  # ARQ repaired every message


@pytest.mark.parametrize("routing", ["shortest", "dimension"])
def test_port_fused_equals_three_program(routing):
    """The port's two engines deliver the same bytes, steps, attribution and
    counters, under a seeded FaultPlan too."""
    rng = np.random.default_rng(5)
    ticks = [_sends(rng, 8, 10, (1, 2)) for _ in range(2)]
    faults = dict(seed=7, drop=0.08, corrupt=0.05)
    out = []
    for fused in (True, False):
        kw = dict(frame_phits=2, credits=2, routing=routing, arq=True, fused=fused)
        fab = _port_fabric((8,), kw, faults)
        out.append((_run(fab, ticks, extra=12)[0], fab.counters_total()))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_attribution_telescopes_exactly():
    """Per message: wait + stall + sum(transit) == arrive_step."""
    rng = np.random.default_rng(6)
    fab = _port_fabric((4, 2), dict(frame_phits=1, credits=1))
    for d in _run(fab, [_sends(rng, 8, 20)])[0]:
        enter, stall, wait, defections, transit = d[6]
        assert wait + stall + sum(transit) == d[5]


def test_exchange_async_then_poll_equals_exchange():
    rng = np.random.default_rng(7)
    sends = _sends(rng, 8, 10)
    a, b = _port_fabric((8,), dict(frame_phits=2)), _port_fabric((8,), dict(frame_phits=2))
    for s, d, w, lvl in sends:
        a.send(s, d, w, lvl)
        b.send(s, d, w, lvl)
    a.exchange()
    assert b.exchange_async() and b.poll() and not b.poll()
    got_a, got_b = [], []
    _drain(a, got_a)
    _drain(b, got_b)
    assert got_a == got_b and len(got_a) == len(sends)


def test_router_host_math_matches_jax():
    jfab = _jax_fabric((4, 2), dict(credits=2))
    tfab = _port_fabric((4, 2), dict(credits=2))
    jr, tr = jfab.router, tfab.router
    for s in range(8):
        for d in range(8):
            assert (tr.hops(s, d), tr.min_hops(s, d), tr.route_hops(s, d)) == (
                jr.hops(s, d), jr.min_hops(s, d), jr.route_hops(s, d))
    srcs, dsts, counts = [0, 1, 5, 7], [6, 2, 5, 0], [3, 1, 4, 2]
    assert tr.plan_steps(srcs, dsts, counts) == jr.plan_steps(srcs, dsts, counts)
    assert tr.default_steps(20) == jr.default_steps(20)
    assert tr.bucket_total(13, 4) == jr.bucket_total(13, 4)
    assert tr._capacities(4, 16) == jr._capacities(4, 16)


def test_fabric_construction_rules():
    with pytest.raises(ValueError, match="exactly one"):
        Fabric(device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        Fabric(grid=(2, 2), n_ranks=4, device="cpu")
    with pytest.raises(ValueError, match="128"):
        Fabric(n_ranks=129, device="cpu")
    from repro_torch.obs import TraceRecorder

    trace = TraceRecorder()
    hooked = Fabric(n_ranks=2, analyze=True, trace=trace, device="cpu")
    assert hooked.analyze and hooked.trace is trace and hooked.spans is None
    fab = Fabric(n_ranks=3, device="cpu")
    with pytest.raises(ValueError, match="empty wire"):
        fab.send(0, 1, b"")
    with pytest.raises(ValueError, match="outside fabric"):
        fab.send(0, 3, b"x")
    fab.send(2, 2, b"self")  # a self-send never crosses a link
    fab.exchange()
    (d,) = fab.mailbox(2).recv()
    assert d.wire == b"self" and d.ok and d.arrive_step == 0


def test_tx_hook_corruption_flagged_like_jax():
    """The three-stage engine's tx_hook sees the framed TX on the host; a
    flipped payload bit flags exactly the message it hit."""
    out = []
    for fab in (_jax_fabric((8,), dict(frame_phits=2, credits=4)),
                _port_fabric((8,), dict(frame_phits=2, credits=4))):
        def hook(tx, tx_valid):
            tx = np.array(tx)
            tx[0, 0, 6] ^= 1 << 3
            return tx
        fab.tx_hook = hook
        fab.send(0, 5, b"a" * 20)
        fab.send(1, 5, b"b" * 20)
        fab.exchange()
        got = []
        _drain(fab, got)
        out.append(got)
    assert out[0] == out[1]
    assert sorted(d[3] for d in out[1]) == [False, True]


# ---------------------------------------------------------------------------
# ARQ on the example that fails the reference's test_arq_identity_property
# ---------------------------------------------------------------------------


def _rel_wires(rng, n, lo=10, hi=200):
    """``tests/test_reliability.py``'s wires, copied."""
    return [bytes(map(int, rng.integers(0, 256, int(rng.integers(lo, hi)))))
            for _ in range(n)]


def _rel_sends(wires):
    """``tests/test_reliability.py``'s fixed multi-pair, multi-frame
    workload over 8 ranks, copied."""
    pairs = [(0, 4), (0, 4), (1, 5), (3, 2), (6, 0), (0, 4), (7, 1)]
    return [(s, d, wires[i % len(wires)], 1 + i % 3) for i, (s, d) in enumerate(pairs)]


def _rel_deliver(fab, sends, max_ticks=300):
    """``tests/test_reliability.py``'s ``_deliver``: send everything, tick
    until every message landed or ``max_ticks`` ran; returns the
    deliveries as (src, dst, wire, ok, level, arrive_step) in arrival
    order."""
    for s, d, w, lvl in sends:
        fab.send(s, d, w, list_level=lvl)
    got = []
    for _ in range(max_ticks):
        fab.exchange()
        for r in range(fab.n_ranks):
            got += [(d.src, r, d.wire, d.ok, d.list_level, d.arrive_step) for d in fab.drain(r)]
        if len(got) >= len(sends):
            break
    return got


def _arq_counters(fab):
    out = {}
    for m in fab.metrics.snapshot()["metrics"]:
        if m["type"] == "counter" and m["name"].startswith("fabric.arq."):
            out[m["name"]] = out.get(m["name"], 0) + m["value"]
    return out


def test_arq_matches_reference_on_its_failing_property_example():
    """The hypothesis example that fails the reference's
    ``test_reliability::test_arq_identity_property`` (drop and corrupt
    0.09375, duplicate 0.25) on that test's workload: the ARQ gives up on
    one frame after ``max_retries`` (one abort) and stream (0, 4) gets a
    short delivery flagged ``ok=False``.  The port does exactly what the
    reference does: the same deliveries, ARQ counters and ticks."""
    rng = np.random.default_rng(0)
    sends = _rel_sends(_rel_wires(rng, 4))
    plan = dict(seed=2005192213, drop=0.09375, corrupt=0.09375, duplicate=0.25)
    kw = dict(frame_phits=2, credits=2, arq=True)  # the fused engine
    jfab = JFabric(n_ranks=8, config=JConfig(**kw))
    jfab.faults = JFaultPlan(**plan)
    tfab = Fabric(n_ranks=8, config=FabricConfig(**kw), device="cpu")
    tfab.faults = FaultPlan(**plan)
    want, got = _rel_deliver(jfab, sends), _rel_deliver(tfab, sends)
    assert got == want
    assert _arq_counters(tfab) == _arq_counters(jfab)
    assert tfab.ticks == jfab.ticks
    assert _arq_counters(tfab)["fabric.arq.aborts"] == 1
    clean = _rel_deliver(Fabric(n_ranks=8, config=FabricConfig(**kw), device="cpu"), sends)
    assert all(d[3] for d in clean) and [d[3] for d in got].count(False) == 1
    bad = next(d for d in got if not d[3])
    assert bad[:2] == (0, 4) and len(bad[2]) < max(len(d[2]) for d in clean if d[:2] == (0, 4))
