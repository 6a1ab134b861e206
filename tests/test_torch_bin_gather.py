"""Parity of the port's power distributor (``nifty_tpu_torch.ops.bin_gather``)
with ``nifty_tpu.ops.pallas_gather``.

The JAX side runs the Pallas kernel bodies in interpret mode, as
``tests/test_pallas_gather.py`` does; the port runs its plain PyTorch
versions, which is what its wrappers do for CPU tensors.  Tolerances: the
gather is a copy (exact); the segment sum adds in another order, so it is
held to 1e-12 of the per-bin sum of |cot| (float64).  The CUDA kernels are
held against the same plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``'s phase 3.
"""

import warnings

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

from nifty_tpu.ops import pallas_gather as pg  # noqa: E402
from nifty_tpu_torch.likelihood import linearize  # noqa: E402
from nifty_tpu_torch.ops import bin_gather as bg  # noqa: E402

torch.set_num_threads(1)

SEG_RTOL = 1e-12


def _index_map(nb, n, seed):
    """A sorted-ish map with ragged blocks and every bin occupied."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, nb, size=n))
    idx[::7] = rng.integers(0, nb, size=len(idx[::7]))
    idx[:nb] = rng.permutation(nb)
    return idx


def _assert_segsum_close(got, want, scale):
    got, want, scale = map(np.asarray, (got, want, scale))
    assert np.all(np.abs(got - want) <= SEG_RTOL * np.maximum(scale, 1e-300))


# nb <= 1024: the select-loop kernels (K1/K2); 1024 < nb <= 4096: the MXU
# one-hot kernels (K3/K4).  B = 1 and B = 8 batch rows of one shared map.
REGIMES = [(96, 9000), (1621, 10000)]


@pytest.mark.parametrize("nb,n", REGIMES, ids=["select_loop", "mxu"])
@pytest.mark.parametrize("nrows", [1, 8])
def test_plain_versions_match_pallas_kernels(monkeypatch, nb, n, nrows):
    rng = np.random.default_rng(nb + nrows)
    idx = _index_map(nb, n, seed=nb)
    table = rng.standard_normal((nrows, nb))
    cot = rng.standard_normal((nrows, n))

    monkeypatch.setattr(pg, "_INTERPRET", True)
    if nb > pg.SMALL_TABLE_MAX_BINS:
        assert pg._use_mxu(nb, n, jnp.float64, False)
    want_g = np.asarray(pg.bin_gather_p.bind(jnp.asarray(table), jnp.asarray(idx)))
    want_s = np.asarray(pg.bin_scatter_p.bind(jnp.asarray(cot), jnp.asarray(idx), nb=nb))
    monkeypatch.setattr(pg, "_INTERPRET", False)

    dist = bg.BinIndex(idx, nb=nb)
    got_g = bg.bin_gather(torch.from_numpy(table), dist).numpy()
    got_s = bg.bin_segment_sum(torch.from_numpy(cot), dist).numpy()
    scale = bg.bin_segment_sum_plain(
        torch.from_numpy(np.abs(cot)), dist.perm, dist.offsets
    ).numpy()
    np.testing.assert_array_equal(got_g, want_g)
    _assert_segsum_close(got_s, want_s, scale)


@pytest.mark.parametrize("nb,n", REGIMES, ids=["select_loop", "mxu"])
def test_distribute_power_and_transforms_match_jax(monkeypatch, nb, n):
    """Forward, jvp, vjp and linearize of a nonlinear function of the
    distributor, against ``distribute_power`` in interpret mode."""
    rng = np.random.default_rng(5)
    idx = _index_map(nb, n, seed=3).reshape(n // 100, 100)
    w = rng.standard_normal(idx.shape)
    t = rng.standard_normal(nb)
    dt = rng.standard_normal(nb)
    ct = rng.standard_normal(idx.shape)

    def f_jax(x):
        return jnp.sin(pg.distribute_power(x, idx)) * w

    monkeypatch.setattr(pg, "_INTERPRET", True)
    y_j, tan_j = jax.jvp(f_jax, (jnp.asarray(t),), (jnp.asarray(dt),))
    _, vjp_j = jax.vjp(f_jax, jnp.asarray(t))
    (cot_j,) = vjp_j(jnp.asarray(ct))
    monkeypatch.setattr(pg, "_INTERPRET", False)

    dist = bg.BinIndex(idx, nb=nb)
    wt = torch.from_numpy(w)

    def f_torch(x):
        return torch.sin(bg.distribute_power(x, dist)) * wt

    tt, dtt, ctt = map(torch.from_numpy, (t, dt, ct))
    y_t, tan_t = torch.func.jvp(f_torch, (tt,), (dtt,))
    _, vjp_t = torch.func.vjp(f_torch, tt)
    (cot_t,) = vjp_t(ctt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # fx const-folding notice
        _, lin = torch.func.linearize(f_torch, tt)
        tan_lin = lin(dtt)
    _, jvp_dbl, vjp_dbl = linearize(f_torch, tt)

    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-13, atol=1e-15)
    for got in (tan_t, tan_lin, jvp_dbl(dtt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(tan_j), rtol=1e-13, atol=1e-13)
    for got in (cot_t, vjp_dbl(ctt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(cot_j), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("nb,n", REGIMES, ids=["select_loop", "mxu"])
def test_adjoint_identity(nb, n):
    """<G x, y> == <x, S y>: the segment sum is the gather's transpose."""
    rng = np.random.default_rng(9)
    dist = bg.BinIndex(_index_map(nb, n, seed=1), nb=nb)
    x = torch.from_numpy(rng.standard_normal((3, nb)))
    y = torch.from_numpy(rng.standard_normal((3, n)))
    lhs = torch.sum(bg.bin_gather(x, dist) * y)
    rhs = torch.sum(x * bg.bin_segment_sum(y, dist))
    assert abs(float(lhs - rhs)) <= 1e-12 * float(torch.sum(x.abs() @ bg.bin_segment_sum(
        y.abs(), dist).T))


def test_vmap_folds_samples_into_rows():
    rng = np.random.default_rng(2)
    nb, n = 50, 700
    dist = bg.BinIndex(_index_map(nb, n, seed=4), nb=nb)
    tables = torch.from_numpy(rng.standard_normal((4, nb)))
    cots = torch.from_numpy(rng.standard_normal((4, n)))
    got_g = torch.func.vmap(lambda t: bg.distribute_power(t, dist))(tables)
    got_s = torch.func.vmap(lambda c: bg.segment_sum(c, dist))(cots)
    want_g = torch.stack([bg.distribute_power(t, dist) for t in tables])
    want_s = torch.stack([bg.segment_sum(c, dist) for c in cots])
    assert torch.equal(got_g, want_g)
    assert torch.equal(got_s, want_s)
    # higher order: the segment sum's derivative is the gather
    y, tan = torch.func.jvp(lambda c: bg.segment_sum(c, dist), (cots[0],), (cots[1],))
    assert torch.equal(tan, bg.segment_sum(cots[1], dist))


def test_sorted_scatter_aux_is_csr_of_stable_sort():
    idx = np.array([[3, 0, 3], [1, 0, 3]])
    aux = bg.sorted_scatter_aux(idx, nb=5)
    np.testing.assert_array_equal(aux["perm"], [1, 4, 3, 0, 2, 5])
    np.testing.assert_array_equal(aux["offsets"], [0, 2, 3, 3, 6, 6])


def test_wrappers_validate_and_count_only_kernel_launches():
    dist = bg.BinIndex(np.array([0, 2, 1, 2]), nb=3)
    bg.reset_launch_counts()
    bg.bin_gather(torch.ones((1, 3)), dist)
    bg.bin_segment_sum(torch.ones((1, 4)), dist)
    assert bg.bin_gather.launches == 0 and bg.bin_segment_sum.launches == 0
    with pytest.raises(ValueError):
        bg.bin_gather(torch.ones((1, 4)), dist)  # wrong table width
    with pytest.raises(TypeError):
        bg.bin_gather(torch.ones((1, 3), dtype=torch.int64), dist)
    with pytest.raises(ValueError):
        bg.bin_segment_sum(torch.ones((1, 8))[:, ::2], dist)  # non-contiguous
    with pytest.raises(ValueError):
        bg.BinIndex(np.array([0, 3]), nb=3)
    meta = bg.BinIndex(np.array([0, 2, 1, 2]), nb=3).to("meta")
    with pytest.raises(RuntimeError, match="no bin_gather kernel"):
        bg.bin_gather(torch.ones((1, 3), device="meta"), meta)
    with pytest.raises(RuntimeError, match="no bin_segment_sum kernel"):
        bg.bin_segment_sum(torch.ones((1, 4), device="meta"), meta)
