"""The port's containers and a tutorial on the card (marker ``gpu``, skipped
without one). No JAX import, so they run where only the port is installed:

    python -m pytest tests/port/test_torch_tutorials_gpu.py -m gpu --confcutdir=tests/port

* ``MPS.empty`` / ``ZTMPS.empty`` with no device land on the card, and
  indexing reads there;
* the zT tutorial runs on the card in complex64 with its own bars: K2 at
  every factorization (no plain Jacobi call on the card) and K1 at its
  readouts. The CPU side of both is in ``test_torch_containers.py`` and
  ``test_torch_tutorials.py``.
"""

import io
from contextlib import redirect_stdout

import pytest
import torch

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.ops.jacobi import jacobi_eigh
from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2
from qilaplace_tpu_torch.ops.readout_kernels import coefficient_batch_k1
from qilaplace_tpu_torch.tutorials import zt


@pytest.mark.gpu
def test_empty_defaults_to_the_card(cuda_device):
    psi = qt.MPS.empty(3)
    assert psi.cores.device.type == "cuda" and psi.ranks.device.type == "cuda"
    qt.validate(psi)
    assert complex(psi[0, 1, 1]) == 0
    z = qt.ZTMPS.empty(2, chi=4)
    assert z.chain.cores.device.type == "cuda" and z.chain.n == 4
    assert complex(z[(0, 0, 1, 1)]) == 0


@pytest.mark.gpu
def test_zt_tutorial_on_the_card(cuda_device):
    k1, k2 = coefficient_batch_k1.launches, jacobi_eigh_k2.launches
    plain = jacobi_eigh.cuda_calls
    with redirect_stdout(io.StringIO()):
        out = zt.run(device=cuda_device, dtype=torch.complex64)
    assert out["err_prod"] < zt.PROD_BAR and out["pole_err"] < zt.POLE_BAR
    assert coefficient_batch_k1.launches > k1
    assert jacobi_eigh_k2.launches > k2
    assert jacobi_eigh.cuda_calls == plain
