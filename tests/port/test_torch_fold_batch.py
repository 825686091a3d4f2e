"""The zT build's factor stacks folded as one batched program, and the
ZTMPS fan-out split as one call, against the JAX package.

The JAX package folds the stacks with ``jax.vmap`` (``transforms/zt.py``
``_build_factors_concurrent``) and splits the n sites' copy tensors with
``jax.vmap`` (``signals/encode.py`` ``signal_ztmps``), so each eigensolve
there is one ``pallas_call`` with the stacks or the sites in its batch.
The port folds ``[S, L, ...]`` layer stacks through one ``compose_layers``
call and splits ``[n, ...]`` copy tensors through one ``svd_split`` call:

* complex128 on the CPU (LAPACK): the port's ``_build_factors_concurrent``
  at n = 3 for cutoff 1e-9 (three stacks, range-mode zips) and 1e-14 (two
  stacks) against the JAX package's: equal ranks, and each factor's dense
  operator within 1e-10 of its largest entry. The cores themselves differ
  by a gauge (each package draws its own sketch and its LAPACK picks its
  own singular-vector phases), so the comparison is of what they compute;
* each slot of the batched fold against its stack folded alone: equal
  ranks, and cores within 1e-12 of the largest entry (bit-identical on
  the CPU); the loop that the card runs, one product a slot
  (``complexlinalg.per_slot``), against the batched call;
* ``signal_ztmps`` (svd and rsvd) on a float64 signal against the JAX
  package's: equal ranks, amplitudes and dense states within 1e-10;
* on the forced device route (``FORCE_DEVICE_PATH``, every eigensolve
  counted, as the card would launch K2): the fold makes exactly the
  eigensolves of one stack folded alone, each with leading dimension S,
  and the ZTMPS split exactly those of one site, each with leading
  dimension n.
"""

import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
import qilaplace_tpu.transforms.zt as jzt
import qilaplace_tpu_torch as qt
import qilaplace_tpu_torch.ops.complexlinalg as tcl
import qilaplace_tpu_torch.signals.encode as tenc
import qilaplace_tpu_torch.transforms.zt as tzt
from qilaplace_tpu_torch.core.mpo import MPO
from qilaplace_tpu_torch.ops.apply import compose_layers
from qilaplace_tpu_torch.transforms.dt import zip_mode_for
from test_torch_batch_launches import wide_eigh_calls  # noqa: F401 (fixture)

N, CHI_F, SEED = 3, 32, 10
CPU = torch.device("cpu")
CUTOFFS = [pytest.param(1e-9, 3, id="three-stacks"),
           pytest.param(1e-14, 2, id="two-stacks")]


def damping():
    """The damping wr, drawn from a seed."""
    return float(np.random.default_rng(SEED).uniform(0.5, 2 * np.pi))


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def factor_stacks(cutoff, dtype):
    """``(acc, lay_c, lay_r, fold_kw)`` of the n = 3 build's fold."""
    return tzt._factor_stacks(N, damping(), cutoff=cutoff, maxdim=1000,
                              chi_f=CHI_F, dtype=dtype, chi_work_f=None,
                              device=CPU)


def alone(acc, lay_c, lay_r, fold_kw, s):
    """Stack ``s`` folded by itself through the unbatched call."""
    return compose_layers(MPO(cores=acc.cores[s], ranks=acc.ranks[s]),
                          lay_c[s], lay_r[s], **fold_kw)


@pytest.mark.parametrize("cutoff,S", CUTOFFS)
def test_factor_fold_matches_jax(cutoff, S):
    wr = damping()
    kw = dict(cutoff=cutoff, maxdim=1000, chi_f=CHI_F, chi_work_f=None)
    got = tzt._build_factors_concurrent(N, wr, dtype=torch.complex128,
                                        device=CPU, **kw)
    want = jzt._build_factors_concurrent(N, wr, dtype=np.complex128, **kw)
    for Wt, Wj in zip(got, want):
        assert Wt.chain.cores.shape == Wj.chain.cores.shape
        assert Wt.chain.ranks.tolist() == np.asarray(Wj.chain.ranks).tolist()
        assert rel(qt.mpo_to_dense(Wt).numpy(),
                   qj.mpo_to_dense(Wj)) <= 1e-10


@pytest.mark.parametrize("cutoff,S", CUTOFFS)
def test_each_slot_is_its_stack_folded_alone(cutoff, S):
    acc, lay_c, lay_r, kw = factor_stacks(cutoff, torch.complex128)
    assert lay_c.shape[0] == S
    assert kw["zip_mode"] == zip_mode_for(cutoff) and kw["maxdim"] == CHI_F
    out = compose_layers(acc, lay_c, lay_r, **kw)
    # the MPO's properties read through the slot axis
    assert out.n == 2 * N and out.chi == CHI_F
    assert out.cores.shape[:-5] == out.ranks.shape[:-1] == (S,)
    for s in range(S):
        ref = alone(acc, lay_c, lay_r, kw, s)
        assert out.ranks[s].tolist() == ref.ranks.tolist()
        assert float(rel(out.cores[s], ref.cores)) <= 1e-12


@pytest.mark.parametrize("case", ["mm-one-axis", "mm-shared", "einsum"])
def test_slot_loop_computes_the_batched_call(case):
    """The card's one-call-a-slot loop (``per_slot``), run here on the
    CPU, gives what the batched call gives: operands with one leading
    axis, and a shared operand and partial axes broadcast over two."""
    g = torch.Generator().manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, dtype=torch.complex128, generator=g)

    if case == "einsum":
        eq = "...xab,aoic,...bid->...xocd"
        xs = (rnd(3, 4, 2, 3), rnd(2, 2, 2, 5), rnd(2, 3, 3, 2, 6))
        fn, cores = (lambda *ys: torch.einsum(eq, *ys)), (3, 4, 3)
    else:
        xs = ((rnd(3, 6, 5), rnd(3, 5, 4)) if case == "mm-one-axis"
              else (rnd(2, 3, 6, 5), rnd(5, 4)))
        fn, cores = torch.matmul, (2, 2)
    leads = [x.shape[:x.dim() - c] for x, c in zip(xs, cores)]
    lead = tcl._broadcast(leads)
    assert lead == tuple(torch.broadcast_shapes(*leads))
    got = tcl._each_slot(fn, xs, leads, lead)
    want = fn(*xs)
    assert got.shape == want.shape and got.shape[:len(lead)] == lead
    assert float(rel(got, want)) <= 1e-14
    # on the CPU the batched call itself is what per_slot gives
    assert torch.equal(tcl.per_slot(fn, *xs, core=cores), want)


@pytest.mark.parametrize("method", ["svd", "rsvd"])
def test_signal_ztmps_matches_jax(method):
    rng = np.random.default_rng(SEED)
    n = 7
    # a rank-3 tensor train: the rsvd sketch captures all of it
    v = rng.normal(size=(1, 2, 3))
    for i in range(1, n):
        v = np.tensordot(v, rng.normal(size=(3, 2, 3 if i < n - 1 else 1)),
                         axes=[[-1], [0]])
    x = v.reshape(-1)
    kw = dict(method=method, cutoff=1e-12, maxdim=32, k=20, p=4, q=1)
    pt = qt.signal_ztmps(x, device="cpu", **kw)
    pj = qj.signal_ztmps(x, **kw)
    assert pt.chain.cores.dtype == torch.float64
    assert pt.chain.chi == pj.chain.chi
    assert pt.chain.ranks.tolist() == np.asarray(pj.chain.ranks).tolist()
    assert abs(float(pt.amplitude) - float(pj.amplitude)) <= 1e-10 * float(
        pj.amplitude)
    assert rel(qt.mps_to_vector(pt).numpy(), qj.mps_to_vector(pj)) <= 1e-10


@pytest.mark.parametrize("cutoff,S", CUTOFFS)
def test_fold_makes_one_stacks_eigensolves(wide_eigh_calls, cutoff, S):
    calls = wide_eigh_calls
    acc, lay_c, lay_r, kw = factor_stacks(cutoff, torch.complex64)
    compose_layers(acc, lay_c, lay_r, **kw)
    batched = list(calls)
    del calls[:]
    alone(acc, lay_c, lay_r, kw, 0)
    one = list(calls)
    assert len(batched) == len(one) > 0
    assert all(sh[:-2] == (S,) for sh in batched)
    assert all(sh[:-2] == () for sh in one)
    assert [sh[-1] for sh in batched] == [sh[-1] for sh in one]
    # the build folds its stacks in that one call: its other eigensolves
    # (Part 2 after Part 1) take one matrix each
    del calls[:]
    tzt._build_factors_concurrent(
        N, damping(), cutoff=cutoff, maxdim=1000, chi_f=CHI_F,
        dtype=torch.complex64, chi_work_f=None, device=CPU)
    assert [sh for sh in calls if sh[:-2] == (S,)] == batched
    assert all(sh[:-2] == () for sh in calls if sh[:-2] != (S,))


def test_ztmps_split_is_one_call_for_every_site(wide_eigh_calls,
                                                 monkeypatch):
    calls = wide_eigh_calls
    n = 7
    x = np.sin(2 * np.pi * 5.3 * np.arange(2**n) / 2**n).astype(np.float32)
    splits = []
    real_split = tenc.svd_split

    def split(M, **kw):
        start = len(calls)
        out = real_split(M, **kw)
        splits.append((M, kw, calls[start:]))
        return out

    monkeypatch.setattr(tenc, "svd_split", split)
    psi = qt.signal_ztmps(x, cutoff=1e-9, maxdim=32, device="cpu")
    assert psi.n == n
    # the TT-SVD's own splits are one matrix each; the fan-out is one
    # split for every site
    [(M, kw, batched)] = [s for s in splits if s[0].dim() == 3]
    assert M.shape[0] == n
    del calls[:]
    real_split(M[0], **kw)
    alone = list(calls)
    assert len(batched) == len(alone) > 0
    assert all(sh[:-2] == (n,) for sh in batched)
    assert [sh[-1] for sh in batched] == [sh[-1] for sh in alone]


def test_version_matches_jax():
    assert qt.__version__ == qj.__version__
