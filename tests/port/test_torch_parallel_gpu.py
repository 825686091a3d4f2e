"""The batched path on the card: a batch of signals through one launch of
kernel K2 per factorization.

Needs a CUDA card (marker ``gpu``; skips here without one) and imports no
JAX:

    python -m pytest tests/port/test_torch_parallel_gpu.py -m gpu --confcutdir=tests/port

- the batched QFT path (encode, zip-up apply, readout; n=12, chi 64, B=8)
  against the one-signal path on each signal, relative to the peak within
  1e-3, and the same batch through ``shard_batch`` on a mesh of one card;
- K2's launches over a batch of 8 equal those over one signal (encode by
  'svd' and 'rsvd', and the QFT path), every batched launch with B = 8, no
  plain Jacobi call on the card;
- K2's cluster variant (m = 128, the largest batched shape at chi 64) at
  B = 8 with a different matrix in every slot: eigenvalues bit-identical to
  the plain version, and each slot equal to that matrix launched alone.
"""

import collections

import numpy as np
import pytest
import torch

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.ops import jacobi_kernels as jk
from qilaplace_tpu_torch.ops.jacobi import default_sweeps, fast_sweeps, jacobi_eigh
from qilaplace_tpu_torch.parallel import (
    batched_qft_pipeline,
    batched_signal_mps,
    make_mesh,
    replicate,
    shard_batch,
)
from qilaplace_tpu_torch.utils.bits import tensor_int_to_bits

from test_torch_k2_gpu import check, hermitian

pytestmark = pytest.mark.gpu

N_BITS, CHI, CUTOFF, B = 12, 64, 1e-9, 8


def signals(n, device):
    """x_j = sin(a_b j), a_b = (b + 1) / N, float32 [B, N] on the card."""
    N = 2**n
    j = torch.arange(N, dtype=torch.float64, device=device)
    a = torch.arange(1, B + 1, dtype=torch.float64, device=device)[:, None]
    return torch.sin(a * j / N).float()


def counted(fn):
    """fn() with K2's launches, its launches by shape and the plain Jacobi
    calls on the card over the call."""
    k2, shapes = jk.jacobi_eigh_k2.launches, collections.Counter(
        jk.jacobi_eigh_k2.by_shape)
    plain = jacobi_eigh.cuda_calls
    out = fn()
    torch.cuda.synchronize()
    new = collections.Counter(jk.jacobi_eigh_k2.by_shape)
    new.subtract(shapes)
    return (out, jk.jacobi_eigh_k2.launches - k2, +new,
            jacobi_eigh.cuda_calls - plain)


def one_signal(W, x, configs):
    psi = qt.signal_mps(x, cutoff=CUTOFF, chi=CHI, device=x.device)
    out = qt.apply(W, psi, maxdim=CHI, cutoff=CUTOFF)
    return qt.coefficient_batch(out, configs)


def test_batched_qft_on_card_matches_one_signal_path(cuda_device):
    n = N_BITS
    W = qt.build_qft_mpo(n, chi=CHI, cutoff=CUTOFF, dtype=torch.complex64,
                         device=cuda_device)
    xs = signals(n, cuda_device)
    configs = tensor_int_to_bits(torch.arange(2**n), n, order="lsb",
                                 device=cuda_device)
    got, k8, shapes8, plain8 = counted(lambda: batched_qft_pipeline(
        W, xs, configs, chi=CHI, cutoff=CUTOFF, device=cuda_device))
    assert got.shape == (B, 2**n)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    _, k1, shapes1, plain1 = counted(lambda: one_signal(W, xs[0], configs))
    assert k8 == k1 > 0 and plain8 == plain1 == 0
    assert all(key[1] == B for key in shapes8)
    for b in range(B):
        ref = one_signal(W, xs[b], configs)
        err = float((got[b] - ref).abs().max() / ref.abs().max())
        assert err <= 1e-3, (b, err)
    mesh = make_mesh(1, devices=[cuda_device])
    sharded = batched_qft_pipeline(replicate(mesh, W), shard_batch(mesh, xs),
                                   configs, chi=CHI, cutoff=CUTOFF)
    assert torch.equal(sharded, got)


@pytest.mark.parametrize("method", ["svd", "rsvd"])
def test_batched_encode_launches_equal(cuda_device, method):
    xs = signals(N_BITS, cuda_device)
    kw = dict(chi=CHI, cutoff=CUTOFF, method=method, device=cuda_device)
    _, k1, shapes1, _ = counted(lambda: batched_signal_mps(xs[:1], **kw))
    _, k8, shapes8, plain = counted(lambda: batched_signal_mps(xs, **kw))
    assert k8 == k1 > 0 and plain == 0
    assert sorted((m, c, s) for (m, _, c, s) in shapes8.elements()) == \
        sorted((m, c, s) for (m, _, c, s) in shapes1.elements())
    assert all(key[1] == B for key in shapes8)


@pytest.mark.parametrize("complex_,sweeps", [
    (True, fast_sweeps(128)), (True, default_sweeps(128)), (False, 4)])
def test_k2_cluster_batch_of_distinct_matrices(cuda_device, complex_, sweeps):
    m = 128
    assert jk.SMEM_MAX_M < m <= jk.CLUSTER_MAX_M
    rng = np.random.default_rng(1280 + sweeps + complex_)
    H = hermitian(rng, B, m, complex_=complex_)
    check(H, sweeps, cuda_device, identical=True)
    Hd = torch.from_numpy(H).to(cuda_device)
    lam, V = jk.jacobi_eigh_k2(Hd, sweeps=sweeps)
    for b in range(B):
        lam_b, V_b = jk.jacobi_eigh_k2(Hd[b:b + 1], sweeps=sweeps)
        assert torch.equal(lam[b], lam_b[0]) and torch.equal(V[b], V_b[0])
