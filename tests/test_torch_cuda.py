"""The port on the card: CUDA kernels against their plain versions.

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
