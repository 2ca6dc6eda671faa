"""The port on the card: CUDA kernels against their plain versions, and the
routed fabric and the sharded and streaming planes on the card against the
host.

Every test here needs a CUDA device; on a host without one they skip.  The
file imports no JAX, so it runs on the card's machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version bit for bit, rows past
the wire included (both read zeros there).
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


@pytest.mark.parametrize("N,fw", [(0, 64), (1, 64), (1, 4), (7, 4), (1000, 64), (33, 2000)])
def test_unpack_frames_kernel_equals_plain(cuda_device, N, fw):
    g = torch.Generator(device=cuda_device).manual_seed(N + fw)
    fr = torch.randint(-2**31, 2**31, (N, 4 + fw), dtype=torch.int32, device=cuda_device,
                       generator=g)
    before = fp.LAUNCHES["unpack_frames_batch"]
    hdr, pay = fp.unpack_frames_batch(fr)
    torch.cuda.synchronize()
    assert fp.LAUNCHES["unpack_frames_batch"] == before + (1 if N else 0)
    want = fp.unpack_frames_batch_plain(fr)
    assert torch.equal(hdr, want[0]) and torch.equal(pay, want[1])


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
    assert fp.LAUNCHES["pack_frames_batch"] >= 1 and fp.LAUNCHES["unpack_frames_batch"] >= 1


def test_sharded_serve_on_card_equals_host(cuda_device):
    cfg = smoke_config(get_config("yi-6b"))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    wires = serve.synthetic_wires(cfg, 5, 3, seed=4)
    kw = dict(max_new=4, pad_to=16, slots=4, n_shards=3)
    fp.reset_launches()
    got = serve.serve_requests_sharded(params_gpu, cfg, wires, device=cuda_device, **kw)
    assert fp.LAUNCHES["pack_frames_batch"] >= 1 and fp.LAUNCHES["unpack_frames_batch"] >= 1
    assert got == serve.serve_requests_sharded(params_cpu, cfg, wires, device="cpu", **kw)
    assert got == serve.serve_requests(params_gpu, cfg, wires, device=cuda_device,
                                       max_new=4, pad_to=16, slots=4)


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
    same wires, tokens and logprobs as the host, through B7."""
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
        out[str(dev)] = (got, sorted(toks), sorted(lps), fp.LAUNCHES["pack_chunks_batch"])
    (gw, gt, glp, glaunch), (hw, ht, hlp, _) = out[str(cuda_device)], out["cpu"]
    assert glaunch >= 1
    assert gw == hw == serve.serve_requests(params_cpu, cfg, wires, device="cpu",
                                            max_new=4, pad_to=16, slots=4)
    assert gt == ht and [e[:4] for e in glp] == [e[:4] for e in hlp]
    np.testing.assert_allclose([e[4] for e in glp], [e[4] for e in hlp], atol=1e-5, rtol=1e-5)
