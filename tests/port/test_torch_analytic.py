"""Analytic zT build: the port against the JAX package.

The host numpy code is the same in both packages, so ranks must be
identical and cores equal to 1e-12 (in practice bit-equal); the torch
assembly of the factor pack is held to the JAX assembly at 1e-12."""

import functools

import numpy as np
import pytest
import torch

import qilaplace_tpu.transforms.analytic as ja

import qilaplace_tpu_torch as qt

TOL = 1e-12
CASES = [(n, wr) for n in (4, 6, 8) for wr in (2 * np.pi, 0.5)]
IDX = ("pre_i", "pre_j", "pre_len", "mid_i", "mid_j", "mid_len")


@functools.lru_cache(maxsize=None)
def packs(n, wr):
    kw = dict(cutoff=1e-12, maxdim=128)
    return ja.zt_product_pack(n, wr, **kw), qt.zt_product_pack(n, wr, **kw)


@pytest.mark.parametrize("n,wr", CASES)
def test_zt_product_pack_matches(n, wr):
    pj, pt = packs(n, wr)
    assert sorted(pj) == sorted(pt)
    for key in IDX + ("ranks", "n"):
        assert np.array_equal(pj[key], pt[key]), key
    for key in ("D", "Q"):
        assert pj[key].shape == pt[key].shape
        assert np.abs(pj[key] - pt[key]).max() <= TOL


@pytest.mark.parametrize("n,wr", CASES)
def test_assemble_product_cores_matches(n, wr):
    pj, pt = packs(n, wr)
    want = np.asarray(ja.assemble_product_cores(
        pj["D"], pj["Q"], *(pj[k] for k in IDX)))
    got = qt.assemble_product_cores(
        torch.from_numpy(pt["D"]), torch.from_numpy(pt["Q"]),
        *(torch.from_numpy(pt[k]) for k in IDX))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL
    W = qt.mpo_from_pack(pt, device="cpu", dtype=torch.complex128)
    assert np.array_equal(W.chain.ranks.numpy(), pt["ranks"])
    qt.validate(W, atol=0.0)


@pytest.mark.parametrize("n,wr", CASES)
def test_analytic_zt_mpo_matches(n, wr):
    kw = dict(cutoff=1e-12, maxdim=128)
    Wj = ja.analytic_zt_mpo(n, wr, dtype=np.complex128, **kw)
    Wt = qt.analytic_zt_mpo(n, wr, dtype=torch.complex128, device="cpu",
                            **kw)
    assert np.array_equal(Wt.chain.ranks.numpy(), np.asarray(Wj.chain.ranks))
    assert np.abs(Wt.chain.cores.numpy() - np.asarray(Wj.chain.cores)).max() \
        <= TOL
    # the pack route assembles the same operator
    Wp = qt.mpo_from_pack(packs(n, wr)[1], device="cpu",
                          dtype=torch.complex128)
    a, b = qt.tighten(Wt).chain, qt.tighten(Wp).chain
    assert torch.equal(a.ranks, b.ranks)
    assert (a.cores - b.cores).abs().max() <= TOL
