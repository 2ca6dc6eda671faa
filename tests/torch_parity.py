"""Process setup shared by the port's tests (``tests/test_torch_*.py``).

Every port test module imports this one, and every pytest-xdist worker
collects every module, so what is set here holds for the whole test
process from collection on.  It is not a test module itself (its name
does not start with ``test_``).

* **Each process uses its share of the cores.**  torch starts one OpenMP
  intra-op thread a core in every process, so ``-n 6`` workers on an
  8-core host ran 48 threads on 8 cores, and the smoke models' ops are
  too small to share: the threads mostly spun against each other.  On
  such a host the port's test files under ``-n 6 --dist loadfile`` took
  598 s of wall time (2,906 test-seconds) with the default pool and 346 s
  (1,655) with a share a worker, the same 919 cases passing
  (``test_torch_examples`` 377 -> 99 test-seconds, ``test_torch_train``
  461 -> 198).  So a process takes the host's cores divided by the
  number of xdist workers (every core without xdist), and
  ``OMP_NUM_THREADS`` says the same to the subprocesses a test starts
  (the examples, the CLIs, the reference's fake-device runs).
* **TF32 is off.**  Parity runs hold float32 logits to the JAX reference,
  so a CUDA matmul or convolution must not round its inputs to TF32.  No
  test turns it back on.
* **Twin models.**  :func:`twin_models` builds the reference's and the
  port's smoke model of an architecture with the same parameters.

JAX and the reference are imported only inside those two functions, so a module
that needs neither (``test_torch_cuda.py``, ``test_torch_analysis.py``)
imports this one on a host without JAX.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config

N_THREADS = max(1, len(os.sched_getaffinity(0))
                // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(N_THREADS)
os.environ["OMP_NUM_THREADS"] = str(N_THREADS)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def twin_configs(arch: str, **changes):
    """``(jcfg, cfg)``: the reference's and the port's smoke configs of
    ``arch`` with the same ``changes``, equal field for field."""
    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_config as j_smoke_config

    jcfg = dataclasses.replace(j_smoke_config(j_get_config(arch)), **changes)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **changes)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def twin_models(arch: str, **changes):
    """``(jcfg, jparams, cfg, tparams)``: :func:`twin_configs`, the
    reference's ``init_params`` at ``PRNGKey(0)``, and those parameters
    carried over to the port on the CPU by ``params_from_jax``."""
    import jax
    from repro.models import init_params as j_init_params

    from repro_torch.models import params_from_jax

    jcfg, cfg = twin_configs(arch, **changes)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
