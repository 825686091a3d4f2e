"""``ZTPipeline.find_poles`` with the pipeline's operators kept in memory, at
n = 10, on a float32 sin_decay state encoded by rsvd (k = 50, p = 5, q = 2)
through ``ZTPipeline(readout="apply")``:

* the search reads the operators that ``ZTPipeline.search_mpo`` keeps,
  tightened once, and its grids and peaks are bit for bit those of
  ``coarse_to_fine_pole_search`` reading the pipeline's artifacts, and
  those of its own build or load, on both readouts;
* ``zt_mpo.loads`` and ``zt_mpo.builds`` count the two operators of a
  fresh pipeline's first ``mpo`` calls and nothing during a later search;
* an override of an operator setting (or a state that asks for complex128
  operators, or one on another device) leaves the pipeline's operators
  out;
* the apply route's three grids lie within ``GRID_TOL`` of the float64
  closed form, and the superfine peak is the closed form's argmax;
* the peaks are those of the JAX package's search on the same state;
* the zip-up's Gaussian sketch is drawn once for its arguments and kept.
"""

import functools
import math

import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.models import pipelines
from qilaplace_tpu_torch.scan.pole_scan import tighten
from qilaplace_tpu_torch.signals.oracles import (
    sin_decay_norm,
    sin_decay_zt_oracle,
)
from qilaplace_tpu_torch.transforms.zt import zt_mpo
from qilaplace_tpu_torch.utils.config import bucket_for

from port_helpers import sin_decay

N_BITS, CHI = 10, 64
SEARCH = dict(coarse_points=32, fine_points=32, superfine_half=4)
STAGES = ("coarse", "fine", "superfine")
# Relative to the signal's peak. The float32 rsvd encode keeps the signal
# only down to the floor of its range finder, which orthonormalises the
# sketch through a Gram eigensolve: about sqrt(8 eps32) = 1e-3 of the
# largest singular value (ops/truncation.py). Measured 3.8e-4 on the coarse
# grid and 1e-5 on the windows; the direct readout of the same state reads
# the same 3.8e-4, and a TT-SVD encode of the same samples 9e-7. The bar is
# twice the floor.
GRID_TOL = 2e-3


def operators_touched() -> int:
    return zt_mpo.loads + zt_mpo.builds


@functools.lru_cache(maxsize=1)
def _setup(cache_dir: str):
    pipe = qt.ZTPipeline(N_BITS, chi=CHI, readout="apply",
                         cache_dir=cache_dir, device="cpu")
    x = sin_decay(N_BITS)(np.arange(2**N_BITS)).astype(np.float32)
    psi = pipe.encode(torch.from_numpy(x), method="rsvd", k=50, p=5, q=2)
    before = operators_touched()
    for wr in (2 * math.pi, 0.5):
        pipe.mpo(wr)
    return pipe, psi, operators_touched() - before


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return _setup(str(tmp_path_factory.mktemp("zt_cache")))


def test_a_fresh_pipeline_builds_two_and_a_search_none(setup):
    pipe, psi, first = setup
    assert psi.chain.dtype == torch.float32
    assert first == 2
    before = (zt_mpo.loads, zt_mpo.builds)
    for readout in ("apply", "direct"):
        pipe.find_poles(psi, readout=readout, **SEARCH)
    assert (zt_mpo.loads, zt_mpo.builds) == before


def the_pipeline_artifacts(pipe):
    """The pipeline's operators read back from their artifacts, tightened
    as the search takes them."""
    return lambda wr: tighten(zt_mpo(
        N_BITS, wr, engine=pipe.engine, cutoff=pipe.build_cutoff,
        maxdim=pipe.chi, chi=pipe.chi, dtype=pipe.dtype, cache=True,
        cache_dir=pipe.cache_dir, device=pipe.device))


@pytest.fixture(scope="module")
def in_memory(setup):
    """The pipeline's search on each readout, run once."""
    pipe, psi, _ = setup
    return functools.lru_cache(maxsize=None)(
        lambda readout: pipe.find_poles(psi, readout=readout, **SEARCH))


@pytest.mark.parametrize("route", ["artifacts", "search_build"])
@pytest.mark.parametrize("readout", ["apply", "direct"])
def test_in_memory_operators_match_the_build_or_load_route(
        setup, in_memory, readout, route):
    pipe, psi, _ = setup
    got = in_memory(readout)
    loads, touched = zt_mpo.loads, operators_touched()
    operators = the_pipeline_artifacts(pipe) if route == "artifacts" else None
    want = qt.coarse_to_fine_pole_search(
        psi, readout=readout, cutoff=pipe.build_cutoff, maxdim=pipe.chi,
        engine=pipe.engine, cache=True, cache_dir=pipe.cache_dir,
        operators=operators, **SEARCH)
    if route == "artifacts":
        assert zt_mpo.loads == loads + 2  # read back from the artifacts
    else:
        assert operators_touched() == touched + 2  # its own build or load
    for stage in STAGES:
        g, w = getattr(got, stage), getattr(want, stage)
        assert torch.equal(g.chi, w.chi), stage
        assert torch.equal(g.ks, w.ks) and torch.equal(g.ls, w.ls), stage
        assert (int(g.k_peak), int(g.l_peak)) == (int(w.k_peak),
                                                  int(w.l_peak)), stage


def test_the_search_operators_are_tightened_once(setup):
    pipe, _, _ = setup
    for wr in (2 * math.pi, 0.5):
        W = pipe.search_mpo(wr)
        assert pipe.search_mpo(wr) is W
        assert W.chain.chi == bucket_for(int(W.chain.ranks.max()))
        assert tighten(W) is W


OVERRIDES = {"cutoff": dict(cutoff=1e-10), "engine": dict(engine="gate"),
             "maxdim": dict(maxdim=32)}


@pytest.mark.parametrize(
    "override", [None, *OVERRIDES, "float64_state", "another_device"])
def test_an_override_leaves_the_pipeline_operators_out(setup, monkeypatch,
                                                       override):
    pipe, psi, _ = setup
    seen = {}
    monkeypatch.setattr(pipelines, "coarse_to_fine_pole_search",
                        lambda psi_z, **kw: seen.update(kw))
    if override == "float64_state":
        pipe.find_poles(psi.to(dtype=torch.float64))
    elif override == "another_device":
        # a pipeline whose operators would land elsewhere than psi; it
        # builds nothing until asked
        elsewhere = qt.ZTPipeline(N_BITS, chi=CHI, readout="apply",
                                  cache_dir=pipe.cache_dir, device="meta")
        elsewhere.find_poles(psi)
    else:
        pipe.find_poles(psi, **OVERRIDES.get(override, {}))
    if override is None:
        assert seen["operators"] == pipe.search_mpo
    else:
        assert "operators" not in seen


def test_an_overridden_cutoff_builds_its_own_operators(setup):
    pipe, psi, _ = setup
    before = operators_touched()
    pipe.find_poles(psi, cutoff=1e-11, readout="direct", **SEARCH)
    assert operators_touched() == before + 2


def closed_form(ks, ls, wr):
    K, L = np.meshgrid(ks.numpy(), ls.numpy(), indexing="ij")
    chi = sin_decay_zt_oracle(N_BITS, K.reshape(-1), L.reshape(-1), wr=wr)
    return (chi * sin_decay_norm(N_BITS)).reshape(K.shape)


def test_apply_grids_match_the_closed_form(setup):
    pipe, psi, _ = setup
    res = pipe.find_poles(psi, **SEARCH)
    everywhere = torch.arange(-3, 4) % 2**N_BITS
    peak = np.abs(closed_form(torch.zeros(1, dtype=torch.int64),
                              everywhere, 2 * math.pi)).max()
    for stage in STAGES:
        st = getattr(res, stage)
        want = closed_form(st.ks, st.ls, st.wr)
        err = np.abs(st.chi.numpy() - want).max() / peak
        assert err <= GRID_TOL, (stage, err)
    st = res.superfine
    i, j = np.unravel_index(np.abs(want).argmax(), want.shape)
    assert (int(st.ks[i]), int(st.ls[j])) == (int(st.k_peak),
                                              int(st.l_peak))


def test_apply_peaks_match_jax(setup, tmp_path):
    pipe, psi, _ = setup
    c = psi.chain
    psi_j = qj.ZTMPS(chain=qj.MPS(cores=c.cores.numpy(),
                                  ranks=c.ranks.numpy(),
                                  amplitude=c.amplitude.numpy()))
    res_j = qj.coarse_to_fine_pole_search(
        psi_j, readout="apply", cutoff=pipe.build_cutoff, maxdim=pipe.chi,
        cache_dir=str(tmp_path), **SEARCH)
    res_t = pipe.find_poles(psi, **SEARCH)
    for stage in STAGES:
        sj, st = getattr(res_j, stage), getattr(res_t, stage)
        assert (int(st.k_peak), int(st.l_peak)) == (int(sj.k_peak),
                                                    int(sj.l_peak)), stage


def test_the_sketch_is_drawn_once():
    from qilaplace_tpu_torch.ops.truncation import _gaussian

    args = (64, 8, torch.complex64, torch.device("cpu"))
    first = _gaussian(*args, 1234)
    assert _gaussian(*args, 1234) is first
    assert torch.equal(_gaussian.__wrapped__(*args, 1234), first)
    assert not torch.equal(_gaussian(*args, 1235), first)
