"""The gate-built zT operator and the apply-then-read scan on the card.

Needs a CUDA card (marker ``gpu``; skips here without one) and imports no
JAX:

    python -m pytest tests/port/test_torch_gate_gpu.py -m gpu --confcutdir=tests/port

* ``build_zt_mpo(3, 2 pi, cutoff=1e-9)`` in complex64 on the card twice:
  through K2, and with every eigensolve on K2's plain version (the plain
  Jacobi solver, on the card). K2 computes what its plain version
  computes, so the two builds have the same bonds and agree within 1e-6
  of the largest entry. At n = 3 the build's eigensolves (220 on the
  CPU's device route) are at m = 40, 64, 80 (shared memory) and 96
  (device memory);
* ``build_zt_mpo(6, 2 pi, cutoff=1e-9)`` in complex64 on the card (every
  eigensolve a K2 launch, none on the plain Jacobi solver) against the
  same route on the CPU (``FORCE_DEVICE_PATH``, complex64: every
  eigensolve on the plain Jacobi solver): the same bonds, and the dense
  operators within 2e-2 of the largest entry. The two lie 1.045e-2 apart
  on the H100: the sums of the CPU's and the card's matrix products
  round differently, and the float32 route's truncations, which already
  cost it 2.7e-2 against complex128 (below), carry that rounding into
  the kept subspaces;
* the card's build against the port's complex128 build on the CPU
  (LAPACK) within 5e-2. That bar is about twice the float32 device
  route's own error at this size: the JAX package's device route
  (``FORCE_DEVICE_PATH``, complex64, on the CPU) lies 2.70e-2 from its
  complex128 build, and the port's 2.75e-2, both with the bonds
  [1, 2, 8, 11, 21, 18, 21, 17, 19, 11, 8, 2, 1] against [..., 31, 28,
  39, ...] in complex128: the float32 rank decisions trim the operator
  (ROADMAP, queue 3). A broken route is O(1) off;
* ``chi_grid`` on the card's complex64 product state launches K1 and reads
  what the plain ``coefficient_batch`` reads, within 1e-5 of the peak;
* the n = 6 build's factor fold (``zt._factor_stacks``: the three
  stacks folded as one batched program, every eigensolve one K2 launch
  with B = 3) against each stack folded alone through the unbatched
  ``compose_layers``: the batched fold makes the K2 launches of one
  stack, every one at B = 3, and each slot has its stack's bonds and
  cores within 1e-5 of the largest entry. K2 gives each slot what it
  gives the matrix alone, and the fold's products, sums and scans run a
  slot at a time on the card (``complexlinalg.per_slot``), so the slots
  are bit-identical to their stacks alone (logged). With batched cuBLAS
  products they were 9.1e-4 apart (cores, slot 0) on the H100.
"""

import functools
import math

import pytest
import torch

import qilaplace_tpu_torch as qt
import qilaplace_tpu_torch.ops.complexlinalg as cl
import qilaplace_tpu_torch.transforms.zt as zt
from qilaplace_tpu_torch.core.mpo import MPO
from qilaplace_tpu_torch.ops.apply import compose_layers
from qilaplace_tpu_torch.ops.jacobi import jacobi_eigh
from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2
from qilaplace_tpu_torch.ops.readout_kernels import coefficient_batch_k1

N, WR, CUTOFF = 6, 2 * math.pi, 1e-9
PLAIN_K2_BAR = 1e-6      # K2 against its plain version, both on the card
SAME_ROUTE_BAR = 2e-2    # the card against the same route on the CPU
DEVICE_ROUTE_BAR = 5e-2  # twice the float32 device route's own error


@functools.lru_cache(maxsize=1)
def card_build():
    """(W on the card, its K2 launches, its plain Jacobi calls there)."""
    k2, plain = jacobi_eigh_k2.launches, jacobi_eigh.cuda_calls
    W = qt.build_zt_mpo(N, WR, cutoff=CUTOFF, dtype=torch.complex64,
                        device="cuda")
    torch.cuda.synchronize()
    return (W, jacobi_eigh_k2.launches - k2,
            jacobi_eigh.cuda_calls - plain)


@functools.lru_cache(maxsize=1)
def host_route_build():
    """The card's route on the CPU: complex64, every eigensolve on the
    plain Jacobi solver."""
    cl.FORCE_DEVICE_PATH = True
    try:
        return qt.build_zt_mpo(N, WR, cutoff=CUTOFF, dtype=torch.complex64,
                               device="cpu")
    finally:
        cl.FORCE_DEVICE_PATH = False


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
def test_gate_build_on_the_card_matches_the_host_build(cuda_device):
    W, k2, plain = card_build()
    assert W.chain.cores.is_cuda and W.chain.cores.dtype == torch.complex64
    assert k2 > 0 and plain == 0
    ref = qt.build_zt_mpo(N, WR, cutoff=CUTOFF, device="cpu")
    # both dense operators are formed on the card, in complex128
    assert rel(qt.mpo_to_dense(W).to(torch.complex128),
               qt.mpo_to_dense(ref.to(cuda_device))) <= DEVICE_ROUTE_BAR


@pytest.mark.gpu
def test_gate_build_through_k2_matches_its_plain_version(cuda_device,
                                                       monkeypatch):
    def build():
        W = qt.build_zt_mpo(3, WR, cutoff=CUTOFF, dtype=torch.complex64,
                            device=cuda_device)
        torch.cuda.synchronize()
        return W

    k2, plain = jacobi_eigh_k2.launches, jacobi_eigh.cuda_calls
    W = build()
    solves = jacobi_eigh_k2.launches - k2
    assert solves > 0 and jacobi_eigh.cuda_calls == plain
    monkeypatch.setattr(cl, "jacobi_eigh_k2", jacobi_eigh)
    ref = build()
    assert jacobi_eigh_k2.launches - k2 == solves
    assert jacobi_eigh.cuda_calls - plain == solves
    gap = rel(qt.mpo_to_dense(W).to(torch.complex128),
              qt.mpo_to_dense(ref).to(torch.complex128))
    print(f"K2 vs its plain version over the n=3 build: {gap:.3e}; bonds "
          f"{W.chain.ranks.tolist()} and {ref.chain.ranks.tolist()}")
    assert W.chain.ranks.tolist() == ref.chain.ranks.tolist()
    assert gap <= PLAIN_K2_BAR


@pytest.mark.gpu
def test_gate_build_on_the_card_matches_the_same_route_on_the_host(
        cuda_device):
    W, _, _ = card_build()
    host = host_route_build()
    gap = rel(qt.mpo_to_dense(W).to(torch.complex128),
              qt.mpo_to_dense(host.to(cuda_device)).to(torch.complex128))
    print(f"card vs host route: {gap:.3e}; bonds {W.chain.ranks.tolist()} "
          f"on the card, {host.chain.ranks.tolist()} on the host")
    assert W.chain.ranks.tolist() == host.chain.ranks.tolist()
    assert gap <= SAME_ROUTE_BAR


@pytest.mark.gpu
def test_chi_grid_reads_the_product_state_through_k1(cuda_device):
    W, _, _ = card_build()
    j = torch.arange(2**N, dtype=torch.float64)
    x = (torch.exp(-j / 2**N) * torch.sin(4 * j / 2**N)).float()
    psi = qt.signal_ztmps(x, cutoff=1e-12, maxdim=128, device=cuda_device)
    out = qt.apply(W, psi, maxdim=128, cutoff=CUTOFF)
    before = coefficient_batch_k1.launches
    ks, ls = torch.arange(0, 2**N, 3), torch.arange(0, 2**N, 5)
    got = qt.chi_grid(out, ks, ls)
    assert coefficient_batch_k1.launches == before + 1
    assert got.shape == (len(ks), len(ls)) and got.is_cuda
    plain = qt.chi_grid(out, ks, ls, use_kernel=False)
    assert coefficient_batch_k1.launches == before + 1
    assert rel(got.to(torch.complex128), plain.to(torch.complex128)) <= 1e-5
    res = qt.pole_scan(out, ks, ls, wr=WR)
    assert torch.equal(res.chi, qt.chi_grid(out, ks, ls))


@pytest.mark.gpu
def test_batched_fold_slots_match_each_stack_folded_alone(cuda_device):
    acc, lay_c, lay_r, kw = zt._factor_stacks(
        N, WR, cutoff=CUTOFF, maxdim=1000, chi_f=32, dtype=torch.complex64,
        chi_work_f=None, device=cuda_device)
    assert lay_c.shape[0] == 3
    k2, plain = jacobi_eigh_k2.launches, jacobi_eigh.cuda_calls
    jacobi_eigh_k2.by_shape.clear()
    out = compose_layers(acc, lay_c, lay_r, **kw)
    torch.cuda.synchronize()
    launches = jacobi_eigh_k2.launches - k2
    assert launches > 0 and jacobi_eigh.cuda_calls == plain
    assert {B for _, B, _, _ in jacobi_eigh_k2.by_shape} == {3}
    for s in range(3):
        k2 = jacobi_eigh_k2.launches
        ref = compose_layers(MPO(cores=acc.cores[s], ranks=acc.ranks[s]),
                             lay_c[s], lay_r[s], **kw)
        torch.cuda.synchronize()
        assert jacobi_eigh_k2.launches - k2 == launches
        gap = rel(out.cores[s], ref.cores)
        print(f"slot {s} vs its stack folded alone: cores {gap:.3e} apart, "
              f"bit-identical {torch.equal(out.cores[s], ref.cores)}; bonds "
              f"{out.ranks[s].tolist()} and {ref.ranks.tolist()}")
        assert out.ranks[s].tolist() == ref.ranks.tolist()
        assert gap <= 1e-5
