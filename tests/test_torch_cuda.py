"""The port on the card: CUDA kernels against their plain versions, and the
routed fabric, the sharded and streaming planes and each model family's
smoke serve on the card against the host.

Every test here needs a CUDA device; on a host without one they skip.  The
file imports no JAX, so it runs on the card's machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version bit for bit, rows past
the wire included (both read zeros there), and each wrapper call is one
launch: B8 at wire views and 2**20 headers, B7's trimmed form at rows of
mixed elem_words, and one trimmed launch per streaming tick that ships.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import batch_plans, lanes_u32
from repro_torch.data.schemas import request_schema
from repro_torch.fabric import Fabric, FabricConfig, FaultPlan
from repro_torch.kernels import frame_pack as fp
from repro_torch.kernels import ops, phit_unpack as pu
from repro_torch.launch import serve
from repro_torch.models import init_params

pytestmark = pytest.mark.cuda

NBYTES = [1, 3, 4, 5, 8, 13, 16]
WIRE_WORDS = 1600


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wire(device, words=WIRE_WORDS, seed=11):
    w = np.random.default_rng(seed).integers(0, 2**32, words, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


@pytest.mark.parametrize("nbytes", NBYTES)
def test_run_kernels_equal_plain(cuda_device, nbytes):
    wire = _wire(cuda_device)
    w4 = 4 * ((nbytes + 3) // 4)
    for base, stride in [(8, w4), (0, 2 * w4), (1, w4), (3, nbytes), (4, nbytes + 1)]:
        count = (4 * WIRE_WORDS - base) // stride + 7  # the last rows run past the wire
        before = dict(pu.LAUNCHES)
        got = pu.unpack_run(wire, base, stride, count, nbytes)
        torch.cuda.synchronize()
        aligned = base % 4 == 0 and stride % 4 == 0
        name = "unpack_run_aligned" if aligned else "unpack_run_general"
        assert pu.LAUNCHES[name] == before[name] + 1
        assert torch.equal(got, pu.unpack_run_general_plain(wire, base, stride, count, nbytes))
        if aligned:
            assert torch.equal(got, pu.unpack_run_aligned_plain(wire, base, stride, count, nbytes))


@pytest.mark.parametrize("nbytes", NBYTES)
def test_gather_kernel_equals_plain(cuda_device, nbytes):
    wire = _wire(cuda_device)
    rng = np.random.default_rng(nbytes)
    offs = torch.from_numpy(rng.integers(-8, 4 * WIRE_WORDS + 8, 1000)).to(cuda_device)
    before = pu.LAUNCHES["unpack_gather"]
    got = pu.unpack_gather(wire, offs, nbytes)
    torch.cuda.synchronize()
    assert pu.LAUNCHES["unpack_gather"] == before + 1
    assert torch.equal(got, pu.unpack_gather_plain(wire, offs, nbytes))


def test_empty_and_tiny_wires(cuda_device):
    empty = torch.empty(0, dtype=torch.int32, device=cuda_device)
    assert pu.unpack_gather(empty, torch.zeros(3, dtype=torch.int64, device=cuda_device),
                            5).eq(0).all()
    assert pu.unpack_run(empty, 1, 5, 0, 5).shape == (0, 2)
    one = _wire(cuda_device, words=1)
    assert torch.equal(pu.unpack_run(one, 1, 3, 4, 3), pu.unpack_run_general_plain(one, 1, 3, 4, 3))


def test_wrapper_rejects_bad_arguments(cuda_device):
    wire = _wire(cuda_device)
    with pytest.raises(ValueError, match="int64"):
        pu.unpack_gather(wire, torch.zeros(4, dtype=torch.int32, device=cuda_device), 4)
    with pytest.raises(ValueError, match="int64 tensor on"):
        pu.unpack_gather(wire, torch.zeros(4, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="1-D int32"):
        pu.unpack_run(wire.long(), 0, 4, 4, 4)
    with pytest.raises(ValueError, match="multiples of 4"):
        pu.unpack_run_aligned(wire, 1, 4, 4, 4)


def test_decode_request_batch_on_card_equals_host(cuda_device):
    cfg = smoke_config(get_config("yi-6b"))
    wires = serve.synthetic_wires(cfg, 8, 3, seed=1, min_len=0, max_len=40)
    wires.append(serve.encode_request(99, []))
    got = serve.decode_request_batch(wires, cuda_device)
    assert got == serve.decode_request_batch(wires, "cpu")
    assert got == [serve.decode_request(w) for w in wires]
    u32, row_bytes = ops.wires_to_u32(wires, cuda_device)
    bp = batch_plans(request_schema(), wires)
    on_card = ops.decode_batch_kernel(u32, row_bytes, bp)
    on_host = ops.decode_batch_kernel(u32.cpu(), row_bytes, bp)
    for p in on_card:
        np.testing.assert_array_equal(lanes_u32(on_card[p]), lanes_u32(on_host[p]))


def test_smoke_serve_on_card_equals_host(cuda_device):
    """float32 smoke model, TF32 off: the card serves the same tokens."""
    cfg = smoke_config(get_config("yi-6b"))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    wires = serve.synthetic_wires(cfg, 3, 3, seed=2)
    kw = dict(max_new=4, pad_to=16, slots=4)
    pu.reset_launches()
    got = serve.serve_requests(params_gpu, cfg, wires, device=cuda_device, **kw)
    assert pu.LAUNCHES["unpack_run_aligned"] >= 1 and pu.LAUNCHES["unpack_gather"] >= 1
    assert got == serve.serve_requests(params_cpu, cfg, wires, device="cpu", **kw)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "gemma2-27b",
                                  "jamba-1.5-large-398b", "xlstm-125m",
                                  "phi-3-vision-4.2b", "whisper-tiny"])
def test_family_smoke_serve_on_card_equals_host(cuda_device, arch):
    """Each model family's float32 smoke model (MoE, windows, gemma2, the
    SSM blocks, the vision prefix, the encoder and cross attention), same
    seeded parameters: the card serves the host's bytes."""
    cfg = smoke_config(get_config(arch))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    wires = serve.synthetic_wires(cfg, 3, 3, seed=2)
    kw = dict(max_new=4, pad_to=16, slots=4)
    got = serve.serve_requests(params_gpu, cfg, wires, device=cuda_device, **kw)
    assert got == serve.serve_requests(params_cpu, cfg, wires, device="cpu", **kw)


# ---------------------------------------------------------------------------
# frame kernels (B5 pack_frames_batch, B6 unpack_frames_batch)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,F,fw", [(0, 3, 64), (1, 1, 4), (3, 5, 64), (17, 2, 2000),
                                    (256, 9, 64)])
def test_pack_frames_kernel_equals_plain(cuda_device, B, F, fw):
    g = torch.Generator(device=cuda_device).manual_seed(B + fw)
    hdr = torch.randint(-2**31, 2**31, (B, F, 4), dtype=torch.int32, device=cuda_device,
                        generator=g)
    pay = torch.randint(-2**31, 2**31, (B, F, fw), dtype=torch.int32, device=cuda_device,
                        generator=g)
    before = fp.LAUNCHES["pack_frames_batch"]
    got = fp.pack_frames_batch(hdr, pay)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["pack_frames_batch"] == before + (1 if B * F else 0)
    assert torch.equal(got, fp.pack_frames_batch_plain(hdr, pay))


@pytest.mark.parametrize("N,fw,offset", [
    # whole phits
    (0, 64, 0), (1, 64, 0), (1, 4, 0), (7, 4, 0), (1000, 64, 0), (33, 2000, 0),
    # the word form: widths that are not whole phits
    (1, 1, 0), (7, 3, 0), (1000, 5, 0), (33, 2001, 0),
    # the word form: frames at a storage offset of 1, 2 or 3 words
    (1000, 64, 1), (1000, 64, 2), (1000, 64, 3), (33, 5, 2),
    # thousands of blocks (both forms)
    (1 << 18, 64, 0), (1 << 18, 63, 0), (1 << 18, 64, 1),
])
def test_unpack_frames_kernel_equals_plain(cuda_device, N, fw, offset):
    """B6 == its plain version bit for bit in one launch (none for N = 0),
    both outputs contiguous."""
    g = torch.Generator(device=cuda_device).manual_seed(N + fw + offset)
    flat = torch.randint(-2**31, 2**31, (offset + N * (4 + fw),), dtype=torch.int32,
                         device=cuda_device, generator=g)
    fr = flat[offset:].view(N, 4 + fw)
    before = fp.LAUNCHES["unpack_frames_batch"]
    hdr, pay = fp.unpack_frames_batch(fr)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["unpack_frames_batch"] == before + (1 if N else 0)
    assert hdr.is_contiguous() and pay.is_contiguous()
    want = fp.unpack_frames_batch_plain(fr)
    assert torch.equal(hdr, want[0]) and torch.equal(pay, want[1])


def test_unpack_frames_word_form_past_32_bits(cuda_device):
    """The word form's 64-bit index math: 2**26 + 5 frames of 65 words
    (more than 2**32 words, 17.4 GB) at a storage offset of one word."""
    N, fw = (1 << 26) + 5, 61
    flat = torch.empty(1 + N * (4 + fw), dtype=torch.int32, device=cuda_device)
    flat.random_(generator=torch.Generator(device=cuda_device).manual_seed(3))
    fr = flat[1:].view(N, 4 + fw)
    assert fr.numel() > 2**32
    before = fp.LAUNCHES["unpack_frames_batch"]
    hdr, pay = fp.unpack_frames_batch(fr)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["unpack_frames_batch"] == before + 1
    assert hdr.is_contiguous() and pay.is_contiguous()
    assert torch.equal(hdr, fr[:, :4]) and torch.equal(pay, fr[:, 4:])
    del flat, fr, hdr, pay
    torch.cuda.empty_cache()


# frame_batch cases: (nbytes per stream, frame_phits, cap words); routes put
# src and dst at their field widths and seq0 within F of 2**16
FRAME_BATCH_CASES = {
    "empty-and-short": ([0, 1, 3, 4, 8], 2, 24),
    "frame-edges": ([32, 33, 31, 64, 65], 2, 24),
    "full-and-over-cap": ([96, 95, 97, 2, 5], 2, 24),
    "fabric-frames": ([0, 257, 1024, 1, 4000], 16, 1024),
    "odd-cap": ([0, 9, 40, 41, 45], 2, 11),  # rows of 11 words: scalar loads
}


def _frame_batch_inputs(device, case, misaligned=False):
    nbytes, phits, cap = FRAME_BATCH_CASES[case]
    B = len(nbytes)
    rng = np.random.default_rng(len(case) + phits)
    flat = torch.from_numpy(rng.integers(0, 2**32, B * cap + 1, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(device)
    pay = (flat[1:] if misaligned else flat[:-1]).view(B, cap)  # a view 4 bytes off
    routes = torch.tensor([[0, 255, 65534], [127, 0, 65535], [5, 200, 65533], [126, 1, 0],
                           [64, 128, 65530]], dtype=torch.int64, device=device)
    levels = torch.tensor([1, 2, 255, 0, 2**32 - 1], dtype=torch.int64, device=device)
    nb = torch.tensor(nbytes, dtype=torch.int64, device=device)
    return pay, nb, routes, levels, phits


@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "view"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["shortest", "adaptive"])
@pytest.mark.parametrize("case", sorted(FRAME_BATCH_CASES))
def test_frame_batch_kernel_equals_plain(cuda_device, case, adaptive, misaligned):
    """The kernel equals the plain structure pass + join, bit for bit."""
    pay, nb, routes, levels, phits = _frame_batch_inputs(cuda_device, case, misaligned)
    want = fp.frame_batch_plain(pay, nb, routes, levels, phits, adaptive)
    before = fp.LAUNCHES["frame_batch"]
    got = fp.frame_batch(pay, nb, routes, levels, phits, adaptive)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["frame_batch"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), fp.frame_batch_plain(pay.cpu(), nb.cpu(), routes.cpu(),
                                                       levels.cpu(), phits, adaptive))


def test_frame_batch_many_frames(cuda_device):
    """More frames than the grid has warps: the blocks stride."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    B, cap = 4099, 1024
    pay = torch.randint(-2**31, 2**31, (B, cap), dtype=torch.int32, device=cuda_device,
                        generator=g)
    nb = torch.randint(0, 4 * cap + 1, (B,), device=cuda_device, generator=g)
    routes = torch.randint(0, 2**16, (B, 3), device=cuda_device, generator=g)
    levels = torch.randint(0, 256, (B,), device=cuda_device, generator=g)
    want = fp.frame_batch_plain(pay, nb, routes, levels, 16, True)
    assert torch.equal(fp.frame_batch(pay, nb, routes, levels, 16, True), want)


def test_pack_frames_kernel_needs_whole_phits(cuda_device):
    with pytest.raises(ValueError, match="whole 16-byte"):
        fp.pack_frames_batch(torch.zeros(2, 4, dtype=torch.int32, device=cuda_device),
                             torch.zeros(2, 6, dtype=torch.int32, device=cuda_device))


def test_framing_on_card_is_one_launch_without_the_crc_loop(cuda_device, monkeypatch):
    """ops.encode_frames_batch and Router.deliver_fused frame a batch with
    one frame_batch launch each: the structure pass and its per-word CRC
    loop never run; the loop runs only in the router's RX check (once per
    fused tick, verify_frames)."""
    from repro_torch.fabric import frames as fr
    from repro_torch.kernels import framing

    def refuse(*a, **k):
        raise AssertionError("the framing structure pass ran on the card")

    pay, nb, routes, levels, phits = _frame_batch_inputs(cuda_device, "fabric-frames")
    want, wn = ops.encode_frames_batch(pay.cpu(), nb.cpu(), routes.cpu(),
                                       list_level=levels.cpu(), frame_phits=phits)
    for name in ("frame_structure", "crc32_words"):
        monkeypatch.setattr(framing, name, refuse)
    monkeypatch.setattr(fr, "frame_structure", refuse)
    crc_calls = []
    inner = fr.crc32_words
    monkeypatch.setattr(fr, "crc32_words", lambda w: (crc_calls.append(1), inner(w))[1])
    before = fp.LAUNCHES["frame_batch"]
    got, n = ops.encode_frames_batch(pay, nb, routes, list_level=levels, frame_phits=phits)
    assert fp.LAUNCHES["frame_batch"] == before + 1 and crc_calls == []
    assert torch.equal(got.cpu(), want) and torch.equal(n.cpu(), wn)

    fab = Fabric(n_ranks=8, config=FabricConfig(arq=False), device=cuda_device)
    ticks = []
    deliver = fab.router.deliver_fused
    fab.router.deliver_fused = lambda *a, **k: (ticks.append(1), deliver(*a, **k))[1]
    rng = np.random.default_rng(7)
    for i in range(12):
        fab.send(i % 8, (3 * i + 1) % 8,
                 rng.integers(0, 256, int(rng.integers(1, 900)), dtype=np.uint8).tobytes())
    before = fp.LAUNCHES["frame_batch"]
    got = []
    for _ in range(6):
        fab.exchange()
        for r in range(8):
            got += [x for x in fab.mailbox(r).recv()]
    assert len(ticks) >= 1 and fp.LAUNCHES["frame_batch"] == before + len(ticks)
    assert len(crc_calls) == len(ticks)  # the RX check, once per tick
    assert len(got) == 12 and all(x.ok for x in got)


@pytest.mark.parametrize("view", [0, 1, 2, 3], ids=lambda v: f"view+{v}")
@pytest.mark.parametrize("nlanes", [1, 3, 4, 5])
def test_dense_run_vector_route(cuda_device, nlanes, view):
    """B1's 16-byte route on dense runs: every start phase, from base_w and
    from a wire that is a view 4, 8 or 12 bytes into its storage, word
    counts that leave a tail, rows past the wire."""
    full = _wire(cuda_device, words=4096 + 3)
    wire = full[view:view + 4096]
    nbytes = 4 * nlanes - (nlanes > 1)
    for base_w in (0, 1, 2, 3, 5, 4000):
        for count in (1, 2, 7, (4096 - base_w) // nlanes, (4096 - base_w) // nlanes + 9):
            before = pu.LAUNCHES["unpack_run_aligned"]
            got = pu.unpack_run_aligned(wire, 4 * base_w, 4 * nlanes, count, nbytes)
            torch.cuda.synchronize()
            assert pu.LAUNCHES["unpack_run_aligned"] == before + 1
            want = pu.unpack_run_aligned_plain(wire, 4 * base_w, 4 * nlanes, count, nbytes)
            assert torch.equal(got, want), (base_w, count)
            assert torch.equal(got.cpu(), pu.unpack_run_aligned_plain(
                wire.cpu(), 4 * base_w, 4 * nlanes, count, nbytes))


def test_frame_kernel_wrappers_refuse_mixed_devices(cuda_device):
    with pytest.raises(ValueError, match="different devices"):
        fp.pack_frames_batch(torch.zeros(2, 4, dtype=torch.int32, device=cuda_device),
                             torch.zeros(2, 8, dtype=torch.int32))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "programs"])
def test_fabric_on_card_equals_host(cuda_device, fused):
    """Seeded sends, ARQ under faults: the card delivers what the host
    delivers, and both frame kernels launch."""
    rng = np.random.default_rng(3)
    sends = [(int(rng.integers(8)), int(rng.integers(8)),
              rng.integers(0, 256, int(rng.integers(1, 600)), dtype=np.uint8).tobytes(),
              int(rng.integers(1, 4))) for _ in range(24)]
    out = []
    fp.reset_launches()
    for dev in (cuda_device, "cpu"):
        fab = Fabric(n_ranks=8, config=FabricConfig(arq=True, retransmit_timeout=2,
                                                    fused=fused), device=dev)
        fab.faults = FaultPlan(seed=5, drop=0.05, corrupt=0.05)
        for s, d, w, lvl in sends:
            fab.send(s, d, w, lvl)
        got = []
        for _ in range(30):
            fab.exchange()
            for r in range(8):
                got += [(r, x.src, x.wire, x.ok, x.arrive_step, x.attribution)
                        for x in fab.mailbox(r).recv()]
        out.append((got, fab.counters_total()))
    assert out[0][0] == out[1][0] and len(out[0][0]) == len(sends)
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert fp.LAUNCHES["frame_batch"] >= 1 and fp.LAUNCHES["unpack_frames_batch"] >= 1


def test_sharded_serve_on_card_equals_host(cuda_device):
    cfg = smoke_config(get_config("yi-6b"))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    wires = serve.synthetic_wires(cfg, 5, 3, seed=4)
    kw = dict(max_new=4, pad_to=16, slots=4, n_shards=3)
    fp.reset_launches()
    got = serve.serve_requests_sharded(params_gpu, cfg, wires, device=cuda_device, **kw)
    assert fp.LAUNCHES["frame_batch"] >= 1 and fp.LAUNCHES["unpack_frames_batch"] >= 1
    assert got == serve.serve_requests_sharded(params_cpu, cfg, wires, device="cpu", **kw)
    assert got == serve.serve_requests(params_gpu, cfg, wires, device=cuda_device,
                                       max_new=4, pad_to=16, slots=4)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-tiny"])
@pytest.mark.parametrize("plane", ["sharded", "streaming"])
def test_multimodal_planes_on_card_equal_host(cuda_device, arch, plane):
    """The vlm and encdec smoke models on the sharded and streaming planes
    (3 shards; logprobs on the streaming one): the card answers with the
    host's bytes and the batched plane's, through the frame kernels."""
    cfg = smoke_config(get_config(arch))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    wires = serve.synthetic_wires(cfg, 4, 3, seed=5)
    kw = dict(max_new=4, pad_to=16, slots=4)
    fn = (serve.serve_requests_sharded if plane == "sharded" else
          lambda *a, **k: serve.serve_requests_streaming(*a, logprobs=True, **k))
    fp.reset_launches()
    got = fn(params_gpu, cfg, wires, device=cuda_device, n_shards=3, **kw)
    assert fp.LAUNCHES["frame_batch"] >= 1 and fp.LAUNCHES["unpack_frames_batch"] >= 1
    assert (fp.LAUNCHES["chunk_bursts"] >= 1) == (plane == "streaming")
    assert got == fn(params_cpu, cfg, wires, device="cpu", n_shards=3, **kw)
    assert got == serve.serve_requests(params_gpu, cfg, wires, device=cuda_device, **kw)


# ---------------------------------------------------------------------------
# stream-fragment kernel (B7 pack_chunks_batch) and the streaming plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("cap", [1, 64])
@pytest.mark.parametrize("elem_words", [1, 2])
@pytest.mark.parametrize("rows", [0, 1, 33])
def test_pack_chunks_kernel_equals_plain(cuda_device, rows, elem_words, cap, masked):
    g = torch.Generator(device=cuda_device).manual_seed(rows * 7 + cap + elem_words)
    meta = torch.randint(-2**31, 2**31, (rows, 3), dtype=torch.int32, device=cuda_device,
                         generator=g)
    toks = torch.randint(-2**31, 2**31, (rows, cap * elem_words), dtype=torch.int32,
                         device=cuda_device, generator=g)
    counts = torch.randint(0, cap + 1, (rows, 1), dtype=torch.int32, device=cuda_device,
                           generator=g)
    ew = elem_words if masked else 0
    before = fp.LAUNCHES["pack_chunks_batch"]
    got = (ops.encode_chunks_batch(meta, toks, counts[:, 0], elem_words) if masked
           else fp.pack_chunks_batch(meta, toks, counts))
    torch.cuda.synchronize()
    assert fp.LAUNCHES["pack_chunks_batch"] == before + (1 if rows else 0)
    assert got.shape == (rows, cap * elem_words + 4)
    assert torch.equal(got, fp.pack_chunks_batch_plain(meta, toks, counts, ew))
    assert torch.equal(got.cpu(), fp.pack_chunks_batch_plain(meta.cpu(), toks.cpu(),
                                                              counts.cpu(), ew))


def test_streaming_serve_on_card_equals_host(cuda_device):
    """float32 smoke model, TF32 off, logprobs on: the card streams the
    same wires, tokens and logprobs as the host, through B7's trimmed form
    (``chunk_bursts``)."""
    cfg = smoke_config(get_config("yi-6b"))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    wires = serve.synthetic_wires(cfg, 5, 3, seed=4)
    kw = dict(max_new=4, pad_to=16, slots=4, n_shards=3, logprobs=True)
    out = {}
    for dev, params in ((cuda_device, params_gpu), ("cpu", params_cpu)):
        toks, lps = [], []
        fp.reset_launches()
        got = serve.serve_requests_streaming(
            params, cfg, wires, device=dev, on_token=lambda *e, t=toks: t.append(e),
            on_logprob=lambda m, j, s, t, lp, acc=lps: acc.append((m, j, s, t, lp)), **kw)
        out[str(dev)] = (got, sorted(toks), sorted(lps), fp.LAUNCHES["chunk_bursts"])
    (gw, gt, glp, glaunch), (hw, ht, hlp, _) = out[str(cuda_device)], out["cpu"]
    assert glaunch >= 1
    assert gw == hw == serve.serve_requests(params_cpu, cfg, wires, device="cpu",
                                            max_new=4, pad_to=16, slots=4)
    assert gt == ht and [e[:4] for e in glp] == [e[:4] for e in hlp]
    np.testing.assert_allclose([e[4] for e in glp], [e[4] for e in hlp], atol=1e-5, rtol=1e-5)


def _burst_inputs(device, rows, cap, seed, view):
    """Rows of mixed elem_words (1, 2 and 3), counts 0..cap, their prefix
    sum; with ``view`` every input is a view at an odd word offset."""
    g = torch.Generator(device=device).manual_seed(seed)
    ew = torch.randint(1, 4, (rows, 1), dtype=torch.int32, device=device, generator=g)
    counts = torch.randint(0, cap + 1, (rows, 1), dtype=torch.int32, device=device,
                           generator=g)
    cap_w = 3 * cap
    if view:  # tokens, meta and counts all start 1 word past an allocation
        buf = torch.randint(-2**31, 2**31, (rows * (cap_w + 4) + 1,), dtype=torch.int32,
                            device=device, generator=g)
        toks = buf[1:1 + rows * cap_w].view(rows, cap_w)
        meta = buf[1 + rows * cap_w:1 + rows * (cap_w + 3)].view(rows, 3)
        counts = torch.cat([counts.new_zeros(1, 1), counts])[1:]
    else:
        toks = torch.randint(-2**31, 2**31, (rows, cap_w), dtype=torch.int32, device=device,
                             generator=g)
        meta = torch.randint(-2**31, 2**31, (rows, 3), dtype=torch.int32, device=device,
                             generator=g)
    lengths = (counts.long() * ew.long())[:, 0] + 4
    offsets = torch.cumsum(lengths, 0) - lengths
    return meta, toks, counts, ew, offsets, int(lengths.sum())


@pytest.mark.parametrize("view", [False, True], ids=["aligned", "view"])
@pytest.mark.parametrize("cap", [1, 5, 40])
@pytest.mark.parametrize("rows", [0, 1, 7, 1000])
def test_chunk_bursts_kernel_equals_plain(cuda_device, rows, cap, view):
    """B7's trimmed form: rows of mixed elem_words at word offsets that are
    rarely 16-byte aligned, one launch, == the padded rows trimmed."""
    args = _burst_inputs(cuda_device, rows, cap, rows + cap, view)
    before = dict(fp.LAUNCHES)
    got = fp.chunk_bursts(*args)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["chunk_bursts"] == before["chunk_bursts"] + (1 if rows else 0)
    assert fp.LAUNCHES["pack_chunks_batch"] == before["pack_chunks_batch"]
    assert got.shape == (args[-1],)
    assert torch.equal(got, fp.chunk_bursts_plain(*args))
    host = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    assert torch.equal(got.cpu(), fp.chunk_bursts_plain(*host))


def test_fragment_bursts_on_card_equal_host(cuda_device):
    """core.stream_plans.encode_fragment_bursts: token and logprob lanes,
    an empty lane, EOS, one launch, every burst == the host codec's."""
    import importlib

    from repro_torch import stream

    sp = importlib.import_module("repro_torch.core.stream_plans")
    rng = np.random.default_rng(5)
    tp, lp = stream.token_stream_plan(), stream.logprob_stream_plan()
    items = []
    for i, plan in enumerate([tp, lp, tp, lp, tp]):
        n_frags = 0 if i == 2 else int(rng.integers(1, 9))
        frags = []
        for k in range(n_frags):
            n = int(rng.integers(0, 5))
            toks = (tuple(int(t) for t in rng.integers(0, 2**32, n, dtype=np.uint64))
                    if plan is tp else
                    tuple((int(rng.integers(0, 2**32)), int(rng.integers(0, 2**32)))
                          for _ in range(n)))
            frags.append(sp.Fragment(100 * i + k, k, toks, eos=(k == n_frags - 1)))
        items.append((plan, frags))
    before = fp.LAUNCHES["chunk_bursts"]
    got = sp.encode_fragment_bursts(items, cuda_device)
    assert fp.LAUNCHES["chunk_bursts"] == before + 1
    assert got == sp.encode_fragment_bursts(items, "cpu")
    assert got == [b"".join(sp.encode_fragment(p, f.stream_id, f.step, f.tokens, f.eos)
                            for f in frags) for p, frags in items]
    assert got[2] == b""


def test_streaming_serve_on_card_is_one_burst_launch_per_tick(cuda_device, monkeypatch):
    """Every flush of a streaming tick's lanes that ships anything is one
    chunk_bursts launch (the drain included); the padded form and the plain
    versions never run; the wires equal the host serve's."""
    from repro_torch import stream

    def refuse(*a, **k):
        raise AssertionError("a plain version ran for CUDA tensors")

    cfg = smoke_config(get_config("yi-6b"))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    wires = serve.synthetic_wires(cfg, 5, 3, seed=4)
    kw = dict(max_new=4, pad_to=16, slots=4, n_shards=3, logprobs=True)
    want = serve.serve_requests_streaming(params_cpu, cfg, wires, device="cpu", **kw)
    shipped = []
    inner = stream.flush_lanes

    def counted(lanes, force=False):
        shipped.append(inner(lanes, force))
        return shipped[-1]

    monkeypatch.setattr(stream, "flush_lanes", counted)
    monkeypatch.setattr(fp, "chunk_bursts_plain", refuse)
    monkeypatch.setattr(fp, "pack_chunks_batch_plain", refuse)
    fp.reset_launches()
    got = serve.serve_requests_streaming(params_gpu, cfg, wires, device=cuda_device, **kw)
    assert got == want
    assert len(shipped) >= 2 and fp.LAUNCHES["pack_chunks_batch"] == 0
    assert fp.LAUNCHES["chunk_bursts"] == sum(1 for n in shipped if n)


# ---------------------------------------------------------------------------
# telemetry on the card: traced serves, launches and host syncs unchanged
# ---------------------------------------------------------------------------


def _untimed(obj):
    """A span export without its host-clock values."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in ("ts_us", "ttft_s")}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _traced_serve(plane, params, cfg, wires, dev, traced, monkeypatch):
    """One streaming or sharded serve on a fresh fabric; returns the wires,
    the span export (None untraced), the kernel launches and the host
    syncs: fabric tick calls and CUDA event and device synchronisations."""
    from repro_torch.obs import MetricsRegistry, SpanTracker, TraceRecorder

    fab = serve.default_serve_fabric(3, device=dev)
    syncs = {"exchange": 0, "exchange_async": 0, "poll": 0, "event": 0, "device": 0}
    for name in ("exchange", "exchange_async", "poll"):
        inner = getattr(fab, name)

        def counted(inner=inner, name=name):
            syncs[name] += 1
            return inner()

        setattr(fab, name, counted)
    ev_sync, dev_sync = torch.cuda.Event.synchronize, torch.cuda.synchronize

    def event_sync(self):
        syncs["event"] += 1
        return ev_sync(self)

    def device_sync(*a, **k):
        syncs["device"] += 1
        return dev_sync(*a, **k)

    monkeypatch.setattr(torch.cuda.Event, "synchronize", event_sync)
    monkeypatch.setattr(torch.cuda, "synchronize", device_sync)
    tel = {}
    if traced:
        tel = dict(trace=TraceRecorder(), metrics=MetricsRegistry(), analyze=True)
        if plane == "streaming":
            tel["spans"] = SpanTracker(tel["trace"])
    fp.reset_launches()
    pu.reset_launches()
    kw = dict(max_new=4, pad_to=16, slots=4, fabric=fab, device=dev, **tel)
    if plane == "streaming":
        got = serve.serve_requests_streaming(params, cfg, wires, logprobs=True, **kw)
    else:
        got = serve.serve_requests_sharded(params, cfg, wires, **kw)
    monkeypatch.undo()
    launches = {**pu.LAUNCHES, **fp.LAUNCHES}
    if traced:
        from repro_torch.obs import validate_trace

        assert validate_trace(tel["trace"].to_json()) == []
        ticks = [e for e in tel["trace"].events if e["name"] == "fabric.tick"]
        assert len(ticks) == fab.exchanges
    export = _untimed(tel["spans"].export()) if "spans" in tel else None
    return got, export, launches, syncs


@pytest.mark.parametrize("plane", ["streaming", "sharded"])
def test_traced_serves_on_card_equal_host(cuda_device, plane, monkeypatch):
    """Trace, spans, metrics and analyze=True on: the card answers with the
    host's bytes and the untraced card run's; the streaming span export
    equals the host's, timestamps removed; and telemetry changes neither
    the kernel launches nor the host syncs (tick calls, event and device
    synchronisations)."""
    cfg = smoke_config(get_config("yi-6b"))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    wires = serve.synthetic_wires(cfg, 5, 3, seed=4)
    card = _traced_serve(plane, params_gpu, cfg, wires, cuda_device, True, monkeypatch)
    plain = _traced_serve(plane, params_gpu, cfg, wires, cuda_device, False, monkeypatch)
    host = _traced_serve(plane, params_cpu, cfg, wires, "cpu", True, monkeypatch)
    assert card[0] == plain[0] == host[0]
    assert card[0] == serve.serve_requests(params_cpu, cfg, wires, device="cpu",
                                           max_new=4, pad_to=16, slots=4)
    assert card[1] == host[1]
    assert card[2] == plain[2] and card[2]["frame_batch"] >= 1
    assert card[2]["unpack_frames_batch"] >= 1 and card[2]["unpack_gather"] >= 1
    if plane == "streaming":
        assert card[2]["chunk_bursts"] >= 1 and card[1]["requests"]
    assert card[3] == plain[3]


# ---------------------------------------------------------------------------
# SER payload run (B4 pack_run), header stamp (B8 stamp_headers) and the
# device-side encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 517])
@pytest.mark.parametrize("nbytes,stride", [(1, 4), (4, 8), (8, 16), (13, 16), (13, 32),
                                           (16, 16)])
def test_pack_run_kernel_equals_plain(cuda_device, n, nbytes, stride):
    g = torch.Generator(device=cuda_device).manual_seed(n + nbytes + stride)
    toks = torch.randint(-2**31, 2**31, (n, (nbytes + 3) // 4), dtype=torch.int32,
                         device=cuda_device, generator=g)
    before = fp.LAUNCHES["pack_run"]
    got = ops.encode_run(toks, stride, nbytes)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["pack_run"] == before + (1 if n else 0)
    assert got.shape == (n * stride // 4,)
    assert torch.equal(got, fp.pack_run_plain(toks, stride, nbytes))
    assert torch.equal(got.cpu(), fp.pack_run_plain(toks.cpu(), stride, nbytes))
    # the SER mirror of the aligned DES run
    assert torch.equal(ops.decode_run(got, 0, stride, n, nbytes),
                       pu.unpack_run_aligned_plain(got, 0, stride, n, nbytes))


def _headers(device, rows):
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1, 3)


@pytest.mark.parametrize("rows", [
    [[0, 100, 1], [128, 0, 2], [512, 64, 1], [1000, 4, 3]],
    [[4, 7, 1], [5, 9, 2]],  # overlapping: word 5 is the first's level slot
    [[4, 7, 1], [4, 9, 2], [4, 11, 3]],  # repeated word
    [],  # H = 0: a copy
    [[1599, 5, 6], [-1, 7, 8], [4000, 1, 1]],  # slots past either end dropped
], ids=["table", "overlap", "repeat", "empty", "out-of-range"])
def test_stamp_headers_kernel_equals_plain(cuda_device, rows):
    wire = _wire(cuda_device)
    hdr = _headers(cuda_device, rows)
    before = fp.LAUNCHES["stamp_headers"]
    got = ops.write_headers(wire, hdr)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["stamp_headers"] == before + 1
    assert torch.equal(got, fp.stamp_headers_plain(wire, hdr))
    want = wire.cpu().numpy().copy()
    for word, size, level in rows:  # the serial stamp, slots outside dropped
        for slot, v in ((word, size), (word + 1, level)):
            if 0 <= slot < want.shape[0]:
                want[slot] = v
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_stamp_headers_kernel_many_conflicts(cuda_device):
    """2**16 headers on 2**12 words: every slot is written many times, so
    the owner pass decides it."""
    wire = _wire(cuda_device, words=1 << 12)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    hdr = torch.randint(-2, (1 << 12) + 2, (1 << 16, 3), dtype=torch.int32,
                        device=cuda_device, generator=g)
    got = fp.stamp_headers(wire, hdr)
    assert torch.equal(got, fp.stamp_headers_plain(wire, hdr))
    assert torch.equal(got.cpu(), fp.stamp_headers_plain(wire.cpu(), hdr.cpu()))


@pytest.mark.parametrize("case", ["view+1", "view+2", "view+3", "sorted 2**20",
                                  "random 2**20"])
def test_stamp_headers_one_launch_views_and_large(cuda_device, case):
    """One launch per call: a wire view at a 4-byte offset that is not
    16-byte aligned (the scalar copy), and tables of 2**20 headers, sorted
    (a framed stream's; no owner pass) or at random words with repeats and
    overlaps (the owner pass)."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    if case.startswith("view"):
        k = int(case[-1])
        wire = _wire(cuda_device, words=WIRE_WORDS + 4)[k:k + WIRE_WORDS]
        assert wire.data_ptr() % 16 != 0
        # words increasing by 2 or more (no owner pass), then two that meet
        for rows in ([[0, 100, 1], [7, 3, 2], [9, 9, 9], [1599, 5, 6]],
                     [[0, 100, 1], [7, 3, 2], [8, 9, 9], [1599, 5, 6]]):
            hdr = _headers(cuda_device, rows)
            before = fp.LAUNCHES["stamp_headers"]
            got = fp.stamp_headers(wire, hdr)
            torch.cuda.synchronize()
            assert fp.LAUNCHES["stamp_headers"] == before + 1
            assert torch.equal(got, fp.stamp_headers_plain(wire, hdr))
        return
    else:
        n_words, n_hdr = 1 << 22, 1 << 20
        wire = _wire(cuda_device, words=n_words)
        hdr = torch.randint(-2**31, 2**31, (n_hdr, 3), dtype=torch.int32, device=cuda_device,
                            generator=g)
        if case.startswith("sorted"):
            hdr[:, 0] = (torch.arange(n_hdr, device=cuda_device) * 4).int()
        else:
            hdr[:, 0] = torch.randint(-4, n_words + 4, (n_hdr,), dtype=torch.int32,
                                      device=cuda_device, generator=g)
    before = fp.LAUNCHES["stamp_headers"]
    got = fp.stamp_headers(wire, hdr)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["stamp_headers"] == before + 1
    assert torch.equal(got, fp.stamp_headers_plain(wire, hdr))
    assert torch.equal(got.cpu(), fp.stamp_headers_plain(wire.cpu(), hdr.cpu()))


def test_empty_wire_stamps_nothing(cuda_device):
    empty = torch.empty(0, dtype=torch.int32, device=cuda_device)
    before = fp.LAUNCHES["stamp_headers"]
    assert fp.stamp_headers(empty, _headers(cuda_device, [[0, 1, 1]])).shape == (0,)
    assert fp.LAUNCHES["stamp_headers"] == before


def test_ser_wrappers_never_take_the_plain_version(cuda_device, monkeypatch):
    """A CUDA tensor launches the kernel: the plain versions are not called."""
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fp, "pack_run_plain", refuse)
    monkeypatch.setattr(fp, "stamp_headers_plain", refuse)
    toks = torch.ones(3, 2, dtype=torch.int32, device=cuda_device)
    assert ops.encode_run(toks, 8, 8).is_cuda
    assert ops.write_headers(_wire(cuda_device), _headers(cuda_device, [[0, 1, 1]])).is_cuda


def test_encode_message_on_card_equals_host(cuda_device):
    """decode on the card (B1/B3) then encode_message gives back the wire,
    and the card's wire equals the host's."""
    from repro_torch.core import decode_message, encode_message, plan_from_wire, wire_to_u8

    cfg = smoke_config(get_config("yi-6b"))
    wires = serve.synthetic_wires(cfg, 4, 3, seed=5, min_len=0, max_len=40)
    for w in wires:
        plan = plan_from_wire(request_schema(), w)
        dec = ops.decode_message_kernel(ops.wire_to_u32(w, cuda_device), plan)
        got = encode_message(len(w), plan, dec)
        assert got.is_cuda and bytes(got.cpu().numpy()) == w
        host = encode_message(len(w), plan, decode_message(wire_to_u8(w, "cpu"), plan))
        assert torch.equal(got.cpu(), host)


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------


def _train_steps(device, wires, cfg, batch, seq, lr_fn):
    from repro_torch.data.pipeline import decode_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(device)
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), lr_fn)
    losses, launches = [], []
    for w in wires:
        before = pu.LAUNCHES["unpack_gather"]
        b = decode_batch(w, batch, seq, device=device)
        launches.append(pu.LAUNCHES["unpack_gather"] - before)
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return np.array(losses), dict(params.named_parameters()), launches


def test_train_steps_on_card_equal_host(cuda_device):
    """The float32 smoke model's train steps (pipeline decode, loss, grads
    in 2 microbatches, AdamW) on the card and on the host, from the same
    parameters and wires: losses ``rtol=1e-5``, parameters ``rtol=1e-4`` and
    5 % of the steps' summed rates (AdamW's normalized step passes a grad
    element's relative float32 noise on whole).  Each step's decode is two
    B3 launches on the card."""
    import dataclasses

    from repro_torch.data import HGumBatchPipeline
    from repro_torch.optim import linear_warmup_cosine

    cfg = dataclasses.replace(smoke_config(get_config("yi-6b")), microbatch=2)
    pipe = HGumBatchPipeline(vocab=cfg.vocab, batch=4, seq=32, seed=1, device="cpu")
    wires = [pipe.host_make_wire() for _ in range(3)]
    lr_fn = linear_warmup_cosine(1e-3, 1, 3)
    card = _train_steps(cuda_device, wires, cfg, 4, 32, lr_fn)
    host = _train_steps("cpu", wires, cfg, 4, 32, lr_fn)
    assert card[2] == [2, 2, 2] and host[2] == [0, 0, 0]
    np.testing.assert_allclose(card[0], host[0], rtol=1e-5)
    atol = 0.05 * sum(float(lr_fn(i)) for i in range(3))
    for n, p in host[1].items():
        torch.testing.assert_close(card[1][n].detach().cpu(), p.detach(), rtol=1e-4, atol=atol)


def test_train_entry_points_default_to_cuda():
    """Without a card, the training entry points raise instead of taking
    the host (runs on the CPU; on a card the default device is valid)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    from repro_torch.data import HGumBatchPipeline
    from repro_torch.data.pipeline import decode_batch
    from repro_torch.device import NoCudaError
    from repro_torch.launch import train

    for call in (lambda: train.train_loop("xlstm-125m", steps=1, batch=2, seq=8),
                 lambda: train.main(["--arch", "yi-6b", "--smoke", "--steps", "1"]),
                 lambda: HGumBatchPipeline(vocab=64, batch=2, seq=8),
                 lambda: decode_batch(b"\0" * 40, 1, 4)):
        with pytest.raises(NoCudaError, match="device='cpu'"):
            call()


def test_framed_sender_on_card_is_one_b5_join(cuda_device):
    """The framed ring channel on the card: one B5 join launch a send, that
    launch == the plain join, and the delivery == the host's."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import make_framed_sender

    rng = np.random.default_rng(5)
    payload = torch.from_numpy(rng.integers(0, 2**32, (8, 1024), dtype=np.uint32).view(np.int32))
    nbytes = torch.from_numpy(rng.integers(0, 4097, 8))
    send = make_framed_sender(Mesh((8,), ("ring",)), "ring", frame_phits=16)
    before = dict(fp.LAUNCHES)
    with fp.recording() as rec:
        card = send(payload.to(cuda_device), nbytes.to(cuda_device))
        torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fp.LAUNCHES.items() if v != before[k]} == \
        {"pack_frames_batch": 1}
    (name, args), = rec
    assert torch.equal(fp.pack_frames_batch(*args), fp.pack_frames_batch_plain(*args))
    for a, b in zip(card, send(payload, nbytes)):
        assert torch.equal(a.cpu(), b)


def test_cross_pod_mean_int8_on_card_equals_host(cuda_device):
    """A smoke model's float32 grads of two batches as the two pods: the
    int8 mean and the new error bit for bit on card and host."""
    from repro_torch.models import loss_fn
    from repro_torch.optim import microbatched_grads
    from repro_torch.runtime import cross_pod_mean_int8, init_error

    cfg = smoke_config(get_config("yi-6b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(9)
    grads = []
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 32)).astype(np.int32))
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1),
                 "loss_mask": torch.ones((2, 32))}
        grads.append(microbatched_grads(lambda p, b: loss_fn(p, cfg, b), params, batch, 1)[1])
    g = {n: torch.stack([grads[0][n], grads[1][n]]).float() for n in grads[0]}
    e = {n: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)) * 1e-4
         for n, t in g.items()}
    host = cross_pod_mean_int8(g, e)
    card = cross_pod_mean_int8({n: t.to(cuda_device) for n, t in g.items()},
                               {n: t.to(cuda_device) for n, t in e.items()})
    for h, c in zip(host, card):
        for n in h:
            assert torch.equal(h[n], c[n].cpu()), n
    assert set(init_error(params)) == set(g)


# ---------------------------------------------------------------------------
# multi-query (granite-34b) and full multi-head (stablelm-3b) attention; the
# MoE example's all-to-all
# ---------------------------------------------------------------------------


def _close(card: torch.Tensor, host: torch.Tensor, what: str) -> None:
    np.testing.assert_allclose(card.float().cpu().numpy(), host.float().numpy(), rtol=1e-4,
                               atol=1e-4, err_msg=what)


@pytest.mark.parametrize("arch", ["granite-34b", "stablelm-3b"])
def test_attention_layouts_smoke_on_card_equal_host(cuda_device, arch):
    """granite's one K/V head under 4 query heads (the grouped reshape at
    its extreme) and stablelm's 4 K/V heads, float32 smoke models, TF32
    off: prefill logits and every layer's K/V cache within 1e-4 of the
    host's, one decode tick (a cache row dropped for a slot past the end)
    the same, and the served bytes equal."""
    from repro_torch.models import decode_step, prefill

    cfg = smoke_config(get_config(arch))
    assert (cfg.n_kv, cfg.n_heads) == ((1, 4) if arch == "granite-34b" else (4, 4))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    tok = torch.from_numpy(np.random.default_rng(4).integers(2, cfg.vocab, (3, 12)).astype(
        np.int32))
    out = {}
    for name, params, dev in (("host", params_cpu, "cpu"), ("card", params_gpu, cuda_device)):
        with torch.no_grad():
            logits, cache = prefill(params, cfg, {"tokens": tok.to(dev)}, cache_len=14)
            cache["pos"] = cache["pos"].clone()
            cache["pos"][2] = 14  # past the cache: its write is dropped
            nxt = logits[:, -1:].argmax(-1).to(torch.int32)
            dlogits, dcache = decode_step(params, cfg, cache, nxt)
        out[name] = (logits, nxt, dlogits, dcache)
    (hl, hn, hd, hc), (cl, cn, cd, cc) = out["host"], out["card"]
    assert cc["layers"][0]["k"].shape[2] == cfg.n_kv
    _close(cl, hl, "prefill logits")
    assert torch.equal(cn.cpu(), hn)
    _close(cd, hd, "decode logits")
    for i, (h, c) in enumerate(zip(hc["layers"], cc["layers"])):
        for k in h:
            _close(c[k], h[k], f"layer {i} {k}")
    assert torch.equal(cc["pos"].cpu(), hc["pos"])
    wires = serve.synthetic_wires(cfg, 3, 3, seed=2)
    kw = dict(max_new=4, pad_to=16, slots=4)
    assert serve.serve_requests(params_gpu, cfg, wires, device=cuda_device, **kw) == \
        serve.serve_requests(params_cpu, cfg, wires, device="cpu", **kw)


def test_moe_example_all_to_all_on_card_equals_host(cuda_device):
    """``examples/torch_moe_dispatch.py``'s routing and expert all-to-all:
    the same routed lists, frames and verdicts on the card as on the host,
    with one ``frame_batch`` and one B6 launch a fabric tick, each equal to
    its plain version at its recorded call."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_moe_dispatch.py"
    spec = importlib.util.spec_from_file_location("torch_moe_dispatch", path)
    md = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(md)
    cfg = smoke_config(get_config("mixtral-8x22b"))
    p = md.init_moe_ffn(cfg, torch.float32, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    host = md.route(p, x, cfg)
    card = md.route(p.to(cuda_device), x.to(cuda_device), cfg)
    np.testing.assert_array_equal(card["top"], host["top"])
    assert card["dropped"] == host["dropped"]
    R = min(md.MAX_RANKS, cfg.moe_experts)
    want = md.expert_all_to_all(host["top"], cfg.moe_experts, R, "cpu")
    fp.reset_launches()
    with fp.recording() as calls:
        got = md.expert_all_to_all(card["top"], cfg.moe_experts, R, cuda_device)
    assert fp.LAUNCHES["frame_batch"] >= 1 and fp.LAUNCHES["unpack_frames_batch"] >= 1
    plain = {"frame_batch": fp.frame_batch_plain,
             "unpack_frames_batch": fp.unpack_frames_batch_plain}
    assert {name for name, _ in calls} == set(plain)
    for name, args in calls:
        a, b = getattr(fp, name)(*args), plain[name](*args)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        assert all(torch.equal(u, v) for u, v in zip(a, b)), name
    assert got["bit_exact"] and got["crc_ok"] and got["all_ok"]
    assert got["frames_routed"] == want["frames_routed"]
    for g, w in zip(got["received"], want["received"]):
        assert [(s, e, ids.tolist()) for s, e, ids in g] == [
            (s, e, ids.tolist()) for s, e, ids in w]


@pytest.mark.parametrize("G,K,D,T,ring,cap,dtype", [
    (8, 4, 128, 160, False, None, torch.bfloat16),  # yi-6b's heads
    (6, 8, 128, 96, True, None, torch.bfloat16),  # mixtral's, in a ring
    (48, 1, 128, 70, False, None, torch.bfloat16),  # granite's MQA: six head groups
    (1, 32, 80, 64, False, None, torch.bfloat16),  # stablelm's MHA
    (2, 16, 128, 300, True, 50.0, torch.bfloat16),  # gemma2's ring and softcap
    (4, 1, 32, 22, False, None, torch.float32),  # a smoke model's
])
def test_decode_attention_kernel_equals_plain(cuda_device, G, K, D, T, ring, cap, dtype):
    """One launch of ``kernels.decode_attention`` against its plain version
    at the registry's head shapes: the caches bit for bit after the append
    (a row past the cache keeps its old K/V), out within the float32 sums'
    order (2e-5) and one rounding to the output dtype."""
    from repro_torch.kernels import decode_attention as da

    g = torch.Generator(device=cuda_device).manual_seed(G * K + D)
    B = 6

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda_device) * scale).to(dtype)

    pos = torch.randint(T // 2, 3 * T if ring else T, (B,), generator=g, device=cuda_device)
    pos[0] = 0
    if not ring:
        pos[-1] = T + 2
    x = dict(q=rnd(B, 1, K, G, D, scale=40.0 if cap else 1.0), k=rnd(B, K, D), v=rnd(B, K, D),
             k_cache=rnd(B, T, K, D), v_cache=rnd(B, T, K, D), pos=pos.to(torch.int32),
             window=T if ring else None, logit_cap=cap)
    ref = {n: t.clone() if isinstance(t, torch.Tensor) else t for n, t in x.items()}
    before = da.LAUNCHES["decode_attention"]
    got = da.append_and_attend(**x)
    torch.cuda.synchronize()
    assert da.LAUNCHES["decode_attention"] == before + 1
    want = da.append_and_attend_plain(**ref)
    assert torch.equal(x["k_cache"], ref["k_cache"]) and torch.equal(x["v_cache"], ref["v_cache"])
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    a, b = got.float(), want.float()
    assert bool(((a - b).abs() <= rtol * torch.maximum(a.abs(), b.abs()) + 2e-5).all())


# ---------------------------------------------------------------------------
# prefill attention (kernels.prefill_attention) against flash_attention
# ---------------------------------------------------------------------------

#: (G, K, D, S, T, dtype, keywords): the cells' heads (yi-6b at its 1024
#: positions, mixtral), granite's MQA, stablelm's MHA at 80, phi-3-vision's
#: 96, gemma2's window and softcap, whisper's encoder and cross attention
#: (S != T, and S = 1 as its decode runs it), q_offset, packed segments,
#: kv_len, p_bf16, a row no key may attend (q_offset < 0: the plain
#: version's mean of v), and the smoke models' float32
PREFILL_ATTN_CASES = [
    (8, 4, 128, 1024, 1024, torch.bfloat16, {}),
    (6, 8, 128, 256, 256, torch.bfloat16, {}),
    (48, 1, 128, 256, 256, torch.bfloat16, {}),
    (1, 8, 80, 256, 256, torch.bfloat16, {}),
    (1, 8, 96, 17, 17, torch.bfloat16, {}),
    (2, 4, 128, 1024, 1024, torch.bfloat16, dict(window=300, logit_cap=50.0)),
    (1, 6, 64, 256, 256, torch.bfloat16, dict(causal=False)),
    (1, 6, 64, 17, 300, torch.bfloat16, dict(causal=False)),
    (1, 6, 64, 1, 300, torch.bfloat16, dict(causal=False)),
    (8, 2, 128, 17, 17, torch.bfloat16, dict(q_offset=5)),
    (6, 2, 64, 256, 256, torch.bfloat16, dict(segments=True)),
    (2, 2, 32, 256, 300, torch.bfloat16, dict(kv_len=200)),
    (8, 2, 128, 256, 256, torch.bfloat16, dict(p_bf16=True)),
    (2, 2, 32, 1, 1, torch.bfloat16, {}),
    (3, 2, 32, 17, 17, torch.bfloat16, dict(q_offset=-5)),
    (4, 2, 32, 17, 17, torch.float32, {}),
    (1, 4, 64, 256, 256, torch.float32, dict(window=64, logit_cap=5.0, q_offset=3)),
    (48, 1, 32, 17, 40, torch.float32, dict(causal=False, segments=True)),
    (2, 2, 32, 33, 33, torch.float32, dict(p_bf16=True)),
    (3, 2, 128, 17, 17, torch.float32, dict(q_offset=-5, kv_len=12)),
]
#: kernel against plain.  Both sum the same float32 products in another
#: order (the kernel's tiles are 64 keys, the plain version's 1024), which
#: moves a float32 result by a few units of 2**-24 of the sums (2e-5 at
#: most here, 1e-5 relative in float32); then both round once to the output
#: dtype, so a value on a rounding edge differs by one unit in the last
#: place: 2**-7 of its size in bfloat16.  With p_bf16 each version rounds
#: each p to bf16 (the kernel against its running max over 64-key tiles,
#: the plain version against its max over 1024), which moves that p v term
#: by at most 2**-8 of p |v| on each side: over a row, 2**-7 of w, the
#: softmax-weighted mean of |v| (the plain version's output over |v|,
#: computed in float32; 2**-8 more for w's own float32 terms); and the
#: plain version also rounds its key block's p @ v to bf16 (its einsum's
#: output dtype), which the kernel does not: with the output's two
#: roundings, 3 * 2**-8 of |out|, under 2**-6
PREFILL_ATTN_RTOL = {torch.bfloat16: 2.0**-7, torch.float32: 1e-5}
PREFILL_ATTN_RTOL_P_BF16 = 2.0**-6
PREFILL_ATTN_ATOL = 2e-5


def _prefill_attn_inputs(case, dev, seed):
    G, K, D, S, T, dtype, kw = case
    g = torch.Generator(device=dev).manual_seed(seed)
    B = 3
    # a softcapped model's scores reach the cap: q scaled up
    scale = 40.0 if kw.get("logit_cap") else 1.0
    q = (torch.randn((B, S, K, G, D), generator=g, device=dev) * scale).to(dtype)
    k, v = (torch.randn((B, T, K, D), generator=g, device=dev).to(dtype) for _ in range(2))
    kw = dict(kw)
    if kw.pop("segments", False):
        kw["segment_q"] = torch.sort(torch.randint(0, 4, (B, S), generator=g, device=dev),
                                     dim=1).values.to(torch.int32)
        kw["segment_k"] = torch.sort(torch.randint(0, 4, (B, T), generator=g, device=dev),
                                     dim=1).values.to(torch.int32)
    return q, k, v, kw


def _plain_prefill_attn(q, k, v, kw):
    """``flash_attention`` with its bf16 ``p @ v`` (``p_bf16``) summed in
    float32, as the reference's einsum sums it: cuBLAS may otherwise reduce
    a bf16 product's split-K partial sums in bf16."""
    from repro_torch.kernels.prefill_attention import flash_attention

    keep = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return flash_attention(q, k, v, **kw)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = keep


@pytest.mark.parametrize("case", PREFILL_ATTN_CASES,
                         ids=lambda c: f"G{c[0]}-K{c[1]}-D{c[2]}-S{c[3]}-T{c[4]}-"
                         f"{str(c[5]).split('.')[-1]}-" + "-".join(sorted(c[6])))
def test_prefill_attention_kernel_equals_plain(cuda_device, case):
    """One launch of ``kernels.prefill_attention.attend`` against
    ``flash_attention`` on the same inputs, within the stated tolerance."""
    from repro_torch.kernels import prefill_attention as pa

    q, k, v, kw = _prefill_attn_inputs(case, cuda_device, seed=sum(case[:5]))
    before = pa.LAUNCHES["prefill_attention"]
    got = pa.attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["prefill_attention"] == before + 1
    want = _plain_prefill_attn(q, k, v, kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    rtol, atol = PREFILL_ATTN_RTOL[q.dtype], PREFILL_ATTN_ATOL
    if kw.get("p_bf16"):
        w = _plain_prefill_attn(q.float(), k.float(), v.float().abs(), {**kw, "p_bf16": False})
        rtol, atol = PREFILL_ATTN_RTOL_P_BF16, atol + 2.0**-7 * (1 + 2.0**-8) * w
    a, b = got.float(), want.float()
    assert bool(torch.isfinite(a).all())
    assert bool(((a - b).abs() <= rtol * torch.maximum(a.abs(), b.abs()) + atol).all()), \
        float((a - b).abs().max())


def test_served_prefill_launches_prefill_attention_once_a_layer(cuda_device):
    """A yi-6b-shaped model in bf16 (the smoke widths, GQA 4 x 2, no remat, so
    the backward pass runs no second forward): one served prefill step
    launches the kernel once per attention layer and never calls
    ``flash_attention``; the same forward under autograd (parameters
    requiring grad) launches it once a layer too, and its backward
    recomputes the plain version once a layer for the gradient."""
    import dataclasses
    from unittest import mock

    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import forward

    cfg = dataclasses.replace(smoke_config(get_config("yi-6b")), dtype="bfloat16", n_kv=2,
                              remat=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    toks = torch.from_numpy(np.random.default_rng(3).integers(2, cfg.vocab, (4, 64)).astype(
        np.int32)).to(cuda_device)
    step = make_prefill_step(cfg, cache_len=80)
    before = pa.LAUNCHES["prefill_attention"]
    with mock.patch.object(pa, "flash_attention", wraps=pa.flash_attention) as plain:
        tok, cache = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        assert pa.LAUNCHES["prefill_attention"] == before + cfg.n_layers
        assert plain.call_count == 0
        for w in params.parameters():
            w.requires_grad_(True)
        logits, _, _ = forward(params, cfg, {"tokens": toks})
        assert pa.LAUNCHES["prefill_attention"] == before + 2 * cfg.n_layers
        assert plain.call_count == 0
        logits.float().sum().backward()
    assert pa.LAUNCHES["prefill_attention"] == before + 2 * cfg.n_layers
    assert plain.call_count == cfg.n_layers
    assert all(w.grad is not None and bool(torch.isfinite(w.grad).all())
               for w in params.parameters())
    assert tuple(tok.shape) == (4, 1) and len(cache["layers"]) == cfg.n_layers


@pytest.mark.parametrize("case", [PREFILL_ATTN_CASES[i] for i in (0, 10, 7, 17)],
                         ids=["G8-D128-S1024", "segments", "cross", "float32-segments"])
def test_prefill_attention_kernel_backward_is_plain_gradient(cuda_device, case):
    """Under autograd ``attend`` still launches the kernel once, with the
    no-grad launch's output bit for bit; its backward is the plain
    version's gradient of the same ``grad``, bit for bit (it recomputes
    that version from the saved q, k and v)."""
    from repro_torch.kernels import prefill_attention as pa

    q, k, v, kw = _prefill_attn_inputs(case, cuda_device, seed=7 + sum(case[:5]))
    with torch.no_grad():
        want_out = pa.attend(q, k, v, **kw)
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(8),
                    device=cuda_device).to(q.dtype)
    before = pa.LAUNCHES["prefill_attention"]
    out = pa.attend(*xs, **kw)
    got = torch.autograd.grad(out, xs, g)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["prefill_attention"] == before + 1
    assert torch.equal(out, want_out)
    want = torch.autograd.grad(pa.flash_attention(*xs, **kw), xs, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
