"""qilaplace_tpu_torch.parallel against qilaplace_tpu.parallel on the CPU.

The JAX side runs as tests/test_parallel.py runs it: float64 / complex128,
unsharded and on the 8-device CPU mesh of tests/conftest.py (the batched
QFT and the fit step). Operators,
states and targets are built by the JAX package and carried across with
utils/interop, so both packages compute on identical inputs; the signal
encoders take the same numpy signals. The port's sharded forms run on a
host mesh of ``["cpu"] * 8`` and must give the unsharded results.

Bars: the batched encode 1e-10 (per element, its decoded vector), the
batched QFT 1e-10 against JAX and 1e-6 against the FFT (the JAX test's
bar), the stacked readouts 1e-12, the fit step 1e-10 (loss and cores),
all relative to the reference's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
import qilaplace_tpu.parallel as pj
import qilaplace_tpu_torch as qt
import qilaplace_tpu_torch.parallel as pt
from qilaplace_tpu.core.mpo import MPO as JMPO
from qilaplace_tpu.core.mpo import mpo_repad as jmpo_repad
from qilaplace_tpu.utils.bits import jnp_int_to_bits, paired_config_from_kl
from qilaplace_tpu_torch.utils.interop import mpo_from_numpy, mps_from_numpy


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def host_mesh(shape):
    return pt.make_mesh(8, shape=shape, devices=["cpu"] * 8)


def element(psi, i):
    """State ``i`` of a batched port MPS."""
    return qt.MPS(cores=psi.cores[i], ranks=psi.ranks[i],
                  amplitude=psi.amplitude[i])


def to_port(obj, paired):
    """A JAX state (with amplitude) or operator as the port's, on the CPU."""
    chain = getattr(obj, "chain", obj)
    if hasattr(chain, "amplitude"):
        return mps_from_numpy(np.array(chain.cores), np.array(chain.ranks),
                              np.asarray(chain.amplitude), device="cpu",
                              paired=paired)
    return mpo_from_numpy(np.array(chain.cores), np.array(chain.ranks),
                          device="cpu", paired=paired)


def tt_signals(B, n, r=3, seed=0):
    """B rank-r tensor-train signals (float64) of different scales, so the
    ranks are exact and no sketch decides them."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(B):
        v = rng.normal(size=(1, 2, r))
        for i in range(1, n):
            v = np.tensordot(v, rng.normal(size=(r, 2, r if i < n - 1 else 1)),
                             axes=[[-1], [0]])
        rows.append(10.0 ** (b - 2) * v.reshape(-1))
    return np.stack(rows)


def test_same_names_as_the_jax_package():
    assert pt.__all__ == pj.__all__


def test_make_mesh_needs_a_card_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.make_mesh()
    mesh = host_mesh((4, 2))
    assert mesh.shape == {"dp": 4, "grid": 2}
    assert mesh.along("dp") == [torch.device("cpu")] * 4


@pytest.mark.parametrize("method", ["svd", "rsvd"])
def test_batched_signal_mps_matches_jax(method):
    n, B = 6, 4
    xs = tt_signals(B, n)
    kw = dict(chi=8, cutoff=1e-12, method=method)
    pj_ = pj.batched_signal_mps(jnp.asarray(xs), **kw)
    pt_ = pt.batched_signal_mps(torch.from_numpy(xs), device="cpu", **kw)
    assert pt_.cores.shape == tuple(pj_.cores.shape)
    assert pt_.ranks.tolist() == np.asarray(pj_.ranks).tolist()
    assert pt_.ranks.max() == 3
    for i in range(B):
        got = qt.mps_to_vector(element(pt_, i)).numpy()
        want = np.asarray(qj.mps_to_vector(jax.tree_util.tree_map(
            lambda a, i=i: a[i], pj_)))
        assert rel(got, want) <= 1e-10
        assert rel(got, xs[i]) <= 1e-10
        one = qt.signal_mps(xs[i], device="cpu", **kw)
        assert one.ranks.tolist() == pt_.ranks[i].tolist()
        assert rel(got, qt.mps_to_vector(one).numpy()) <= 1e-12


def test_batched_signal_mps_cross_has_no_batch_form():
    xs = tt_signals(2, 4)
    with pytest.raises(ValueError, match="cross"):
        pt.batched_signal_mps(torch.from_numpy(xs), chi=8, method="cross",
                              device="cpu")
    with pytest.raises(Exception):
        pj.batched_signal_mps(jnp.asarray(xs), chi=8, method="cross")


def test_batched_qft_pipeline_matches_jax_and_fft():
    n, chi, B = 5, 16, 8
    N = 2**n
    xs = np.random.default_rng(0).normal(size=(B, N))
    Wj = qj.build_qft_mpo(n, dtype=np.complex128)
    configs = jnp_int_to_bits(jnp.arange(N), n, order="lsb")
    want = np.asarray(pj.batched_qft_pipeline(
        Wj, pj.shard_batch(pj.make_mesh(8, shape=(8, 1)), jnp.asarray(xs)),
        configs, chi=chi, cutoff=1e-12))
    W = to_port(Wj, paired=False)
    cfg = torch.from_numpy(np.array(configs))
    got = pt.batched_qft_pipeline(W, torch.from_numpy(xs), cfg, chi=chi,
                                  cutoff=1e-12, device="cpu")
    assert got.shape == (B, N)
    assert rel(got, want) <= 1e-10
    assert rel(got, np.fft.fft(xs, axis=1) / np.sqrt(N)) <= 1e-6
    mesh = host_mesh((8, 1))
    sharded = pt.batched_qft_pipeline(
        pt.replicate(mesh, W), pt.shard_batch(mesh, torch.from_numpy(xs)),
        cfg, chi=chi, cutoff=1e-12)
    assert rel(sharded, got) <= 1e-12


@pytest.fixture(scope="module")
def zt_stack():
    """Four analytic zT operators at n=8 (one repadded to chi 128, so that
    stacking repads the others), a cross-encoded state and 64 random
    (k, l) configurations, from the JAX package."""
    n = 8
    N = 2**n
    j = np.arange(N)
    x = np.exp(-3.0 * j / N) * np.sin(0.2 * j)
    psi = qj.tighten(qj.signal_ztmps(x, method="cross", cutoff=1e-12,
                                     maxdim=64))
    Ws = [qj.zt_mpo(n, wr, engine="analytic", cutoff=1e-12, maxdim=64,
                    dtype=np.complex128, cache=False)
          for wr in (0.5, 1.0, 2 * np.pi, 4 * np.pi)]
    Ws[2] = jmpo_repad(Ws[2], 128)
    rng = np.random.default_rng(3)
    configs = paired_config_from_kl(jnp.asarray(rng.integers(0, N, 64)),
                                    jnp.asarray(rng.integers(0, N, 64)), n)
    return Ws, psi, configs


def test_stack_mpos_and_multi_chi_batch_match_jax(zt_stack):
    Wjs, psij, configs = zt_stack
    stacked_j = pj.stack_mpos(Wjs)
    stacked = pt.stack_mpos([to_port(W, paired=True) for W in Wjs])
    assert isinstance(stacked, qt.PairedSiteMPO)
    assert torch.equal(stacked.chain.cores,
                       torch.from_numpy(np.array(stacked_j.chain.cores)))
    assert stacked.chain.ranks.tolist() == np.asarray(
        stacked_j.chain.ranks).tolist()
    psi = to_port(psij, paired=True)
    cfg = torch.from_numpy(np.array(configs))
    got = pt.multi_mpo_chi_batch(stacked, psi, cfg)
    want = np.asarray(pj.multi_mpo_chi_batch(stacked_j, psij, configs))
    assert got.shape == (4, 64)
    assert rel(got, want) <= 1e-12
    for i, W in enumerate(Wjs):
        single = qt.apply_coefficient_batch(to_port(W, paired=True), psi, cfg)
        assert rel(got[i], single) <= 1e-12


def test_multi_chi_batch_shared_prefixes_match_jax(zt_stack):
    """The stacked readout on a pole search's coarse configs (the full
    plane at stride N / 16): every row shares its first 8 sites, so each
    operator's environments are contracted once per distinct prefix."""
    Wjs, psij, _ = zt_stack
    N = 2**8
    K, L = np.meshgrid(np.arange(0, N, N // 16), np.arange(0, N, N // 16),
                       indexing="ij")
    configs = paired_config_from_kl(jnp.asarray(K.reshape(-1)),
                                    jnp.asarray(L.reshape(-1)), 8)
    stacked = pt.stack_mpos([to_port(W, paired=True) for W in Wjs])
    psi = to_port(psij, paired=True)
    cfg = torch.from_numpy(np.array(configs))
    got = pt.multi_mpo_chi_batch(stacked, psi, cfg)
    want = np.asarray(pj.multi_mpo_chi_batch(pj.stack_mpos(Wjs), psij,
                                             configs))
    assert got.shape == (4, 256)
    assert rel(got, want) <= 1e-12
    for i, W in enumerate(Wjs):
        single = qt.apply_coefficient_batch(to_port(W, paired=True), psi, cfg)
        assert rel(got[i], single) <= 1e-12


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_sharded_multi_scan_matches_unsharded(zt_stack, shape):
    Wjs, psij, configs = zt_stack
    Ws = [to_port(W, paired=True) for W in Wjs]
    stacked = pt.stack_mpos(Ws + Ws)  # 8 operators: dp up to 8
    psi = to_port(psij, paired=True)
    cfg = torch.from_numpy(np.array(configs))
    want = pt.multi_mpo_chi_batch(stacked, psi, cfg)
    got = pt.sharded_multi_scan(host_mesh(shape), stacked, psi, cfg)
    assert got.shape == (8, 64)
    assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_sharded_chi_grid_matches_unsharded(zt_stack, shape):
    Wjs, psij, configs = zt_stack
    out_j = qj.apply(Wjs[0], psij)
    out = to_port(out_j, paired=True)
    cfg = torch.from_numpy(np.array(configs))
    want = qt.coefficient_batch(out, cfg)
    got = pt.sharded_chi_grid(host_mesh(shape), out, cfg)
    assert got.shape == (64,)
    assert rel(got, want) <= 1e-12
    assert rel(got, qj.coefficient_batch(out_j, configs)) <= 1e-12


def test_fit_mpo_step_matches_jax():
    n, chi, B = 4, 8, 8
    N = 2**n
    rng = np.random.default_rng(2)
    xs = jnp.asarray(rng.normal(size=(B, N)))
    W_true = jmpo_repad(qj.build_qft_mpo(n, dtype=np.complex128), chi)
    psis_j = pj.batched_signal_mps(xs, chi=chi, cutoff=1e-12)
    configs = jnp_int_to_bits(jnp.arange(N), n, order="lsb")
    targets = jax.vmap(
        lambda p: qj.coefficient_batch(qj.apply(W_true, p), configs))(psis_j)
    W0_j = JMPO(cores=W_true.cores + 0.05 * jnp.asarray(
        rng.normal(size=W_true.cores.shape)), ranks=W_true.ranks)
    mesh_j = pj.make_mesh(8, shape=(8, 1))
    psis_js = jax.tree_util.tree_map(lambda a: pj.shard_batch(mesh_j, a),
                                     psis_j)
    tg_js = pj.shard_batch(mesh_j, targets)
    W1_j, loss0_j = pj.fit_mpo_step(W0_j, psis_js, configs, tg_js, lr=0.02)
    W2_j, loss1_j = pj.fit_mpo_step(W1_j, psis_js, configs, tg_js, lr=0.02)

    W0 = to_port(W0_j, paired=False)
    psis = to_port(psis_j, paired=False)
    cfg = torch.from_numpy(np.array(configs))
    tg = torch.from_numpy(np.array(targets))
    mesh = host_mesh((8, 1))
    runs = {
        "unsharded": (psis, tg),
        "sharded": (pt.shard_batch(mesh, psis), pt.shard_batch(mesh, tg)),
    }
    for name, (p, t) in runs.items():
        W1, loss0 = pt.fit_mpo_step(W0, p, cfg, t, lr=0.02)
        W2, loss1 = pt.fit_mpo_step(W1, p, cfg, t, lr=0.02)
        assert float(loss1) < float(loss0), name
        assert abs(float(loss0) - float(loss0_j)) <= 1e-10 * float(loss0_j)
        assert abs(float(loss1) - float(loss1_j)) <= 1e-10 * float(loss1_j)
        # the update W - lr * grad (torch) equals JAX's W - lr * conj(grad)
        assert rel(W1.cores, W1_j.cores) <= 1e-10, name
        assert rel(W2.cores, W2_j.cores) <= 1e-10, name


def test_dryrun_multichip_on_a_host_mesh():
    from qilaplace_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(8, devices=["cpu"] * 8)
    assert out["mesh"] == {"dp": 4, "grid": 2}
    assert 0 < out["loss1"] < out["loss0"]
    assert out["scan_shape"] == (64,) and len(out["peaks"]) == 4
