"""Parity of the port's sample export and plots with ``nifty_tpu``'s on
the same numpy inputs: a FITS file byte-identical to the JAX package's for
the same array (and ``read_fits`` returning it exactly), the HDF5 export's
``mean``, ``std`` and ``samples`` datasets within 1e-12 (datasets, not
file bytes: h5py stores times), ``save_samples_to_fits`` writing the same
bytes, the orbax-named checkpoint round trip, and ``Plot.output`` drawing
the same panels with the same arrays handed to ``imshow`` (and the same
lines to ``plot`` / ``loglog``).  The plot tests skip where matplotlib is
absent, the HDF5 tests where h5py is."""

import os

import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _samples(mod, arr, pos, resid):
    return mod.Samples(pos={"x": arr(pos)}, samples=None if resid is None else {"x": arr(resid)})


def _pair(pos, resid):
    return (_samples(jft, jnp.asarray, pos, resid),
            _samples(jt, torch.from_numpy, pos, resid))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -- FITS ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 9), (5,), (3, 4, 7)])
def test_fits_is_byte_identical_and_round_trips(tmp_path, shape):
    arr = np.random.default_rng(len(shape)).normal(size=shape)
    header = {"object": "sky", "bunit": 1.5, "flag": True}
    jft.write_fits(str(tmp_path / "j.fits"), arr, extra_header=header)
    jt.write_fits(str(tmp_path / "t.fits"), torch.from_numpy(arr), extra_header=header)
    assert _bytes(tmp_path / "t.fits") == _bytes(tmp_path / "j.fits")
    back = jt.read_fits(str(tmp_path / "t.fits"))
    assert back.shape == shape and np.array_equal(back, arr)
    with pytest.raises(FileExistsError):
        jt.write_fits(str(tmp_path / "t.fits"), arr)
    jt.write_fits(str(tmp_path / "t.fits"), 2 * arr, overwrite=True)
    assert np.array_equal(jt.read_fits(str(tmp_path / "t.fits")), 2 * arr)


@pytest.mark.parametrize("n_samples", [0, 3])
def test_save_samples_to_fits_matches_jax(tmp_path, n_samples):
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(4, 4))
    resid = rng.normal(size=(n_samples, 4, 4)) if n_samples else None
    s_j, s_t = _pair(pos, resid)
    jft.save_samples_to_fits(s_j, str(tmp_path / "j"), lambda s: s["x"] * 3.0,
                             samples_files=True)
    jt.save_samples_to_fits(s_t, str(tmp_path / "t"), lambda s: s["x"] * 3.0,
                            samples_files=True)
    j_files = sorted(f[1:] for f in os.listdir(tmp_path) if f.startswith("j"))
    t_files = sorted(f[1:] for f in os.listdir(tmp_path) if f.startswith("t"))
    assert t_files == j_files and ".mean.fits" in t_files
    assert (".std.fits" in t_files) == (n_samples > 0)
    for f in t_files:
        assert _bytes(tmp_path / ("t" + f)) == _bytes(tmp_path / ("j" + f))


# -- HDF5 ----------------------------------------------------------------------


@pytest.mark.parametrize("n_samples", [0, 4])
def test_hdf5_export_matches_jax(tmp_path, n_samples):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(5)
    pos = rng.normal(size=8)
    resid = rng.normal(size=(n_samples, 8)) if n_samples else None
    s_j, s_t = _pair(pos, resid)
    ops_j = {"sky": lambda s: jnp.exp(s["x"]), "sq": lambda s: s["x"] ** 2}
    ops_t = {"sky": lambda s: torch.exp(s["x"]), "sq": lambda s: s["x"] ** 2}
    jft.save_samples_to_hdf5(s_j, str(tmp_path / "j.h5"), ops_j)
    jt.save_samples_to_hdf5(s_t, str(tmp_path / "t.h5"), ops_t)
    with h5py.File(tmp_path / "j.h5") as fj, h5py.File(tmp_path / "t.h5") as ft:
        assert sorted(ft) == sorted(fj) == ["sky", "sq"]
        for name in fj:
            assert sorted(ft[name]) == sorted(fj[name])
            for ds in fj[name]:
                want, got = fj[name][ds][...], ft[name][ds][...]
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    with pytest.raises(FileExistsError):
        jt.save_samples_to_hdf5(s_t, str(tmp_path / "t.h5"), ops_t)
    jt.save_samples_to_hdf5(s_t, str(tmp_path / "t.h5"), ops_t, overwrite=True,
                            samples_datasets=False)
    with h5py.File(tmp_path / "t.h5") as ft:
        assert "samples" not in ft["sky"]


# -- the checkpoint under the JAX package's orbax names -----------------------------


def test_orbax_named_checkpoint_round_trips(tmp_path):
    rng = np.random.default_rng(6)
    s = jt.Samples(pos={"x": torch.from_numpy(rng.normal(size=5))},
                   samples={"x": torch.from_numpy(rng.normal(size=(2, 5)))}, keys=[3, 4])
    state = jt.OptimizeVIState(nit=7, key=11)
    jt.save_checkpoint_orbax(str(tmp_path / "ck"), s, state)
    back, aux = jt.load_checkpoint_orbax(str(tmp_path / "ck"))
    assert aux == {"nit": 7, "key": 11} and list(back.keys) == [3, 4]
    assert torch.equal(back.pos["x"], s.pos["x"])
    assert torch.equal(back._samples["x"], s._samples["x"])
    jt.save_checkpoint_orbax(str(tmp_path / "ck0"), s)
    assert jt.load_checkpoint_orbax(str(tmp_path / "ck0"))[1] == {"nit": 0, "key": None}


# -- plots ---------------------------------------------------------------------------


@pytest.fixture
def drawn(monkeypatch):
    """Every array handed to ``imshow``, ``plot`` and ``loglog``, in order."""
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    from matplotlib.axes import Axes

    calls = []
    for method in ("imshow", "plot", "loglog"):
        orig = getattr(Axes, method)

        def record(self, *args, _orig=orig, _method=method, **kw):
            calls.append((_method, [np.array(a, dtype=float) for a in args
                                    if not isinstance(a, str)]))
            return _orig(self, *args, **kw)

        monkeypatch.setattr(Axes, method, record)
    return calls


def _panels(mod, arr, rng_seed):
    rng = np.random.default_rng(rng_seed)
    s2 = mod.RGSpace((16, 12), 1 / 16)
    h = s2.get_default_codomain()
    gl, hp = mod.GLSpace(8), mod.HPSpace(4)
    p = mod.Plot()
    p.add(mod.makeField(s2, arr(rng.normal(size=(16, 12)))), title="field")
    p.add(rng.normal(size=32), label="history")
    p.add(mod.power_analyze(mod.makeField(h, arr(rng.normal(size=(16, 12))))), title="power")
    p.add(mod.makeField(gl, arr(rng.normal(size=gl.shape))), title="GL")
    p.add(mod.makeField(hp, arr(rng.normal(size=hp.shape))), title="HP")
    p.add(rng.uniform(size=(5, 12, 16)), freqs_as_rgb=True, title="rgb")
    return p, rng


def test_plot_panels_and_arrays_match_jax(tmp_path, drawn):
    from nifty_tpu.plot import EnergyHistory as JEH
    from nifty_tpu_torch.plot import EnergyHistory as TEH

    got = {}
    for name, mod, arr, EH in (("j", jft, jnp.asarray, JEH), ("t", jt, torch.from_numpy, TEH)):
        p, rng = _panels(mod, arr, 9)
        eh = EH()
        for i, e in enumerate([10.0, 5.0, 3.0, 2.5]):
            eh.append(i, e)
        p.add(eh, title="energy")
        p.add_uncertainty(arr(rng.normal(size=(6, 16, 16))), title="posterior")
        p.add(arr(rng.normal(size=(16, 16))))
        n_panels = len(p._panels)
        drawn.clear()
        fn = str(tmp_path / f"{name}.png")
        p.output(name=fn)
        assert os.path.getsize(fn) > 1000
        got[name] = (n_panels, list(drawn))
    (n_j, calls_j), (n_t, calls_t) = got["j"], got["t"]
    assert n_t == n_j == 10
    assert [c[0] for c in calls_t] == [c[0] for c in calls_j]
    assert sum(c[0] == "imshow" for c in calls_t) == 7
    for (_, args_t), (_, args_j) in zip(calls_t, calls_j):
        assert len(args_t) == len(args_j)
        for a_t, a_j in zip(args_t, args_j):
            assert a_t.shape == a_j.shape
            np.testing.assert_allclose(a_t, a_j, rtol=0, atol=1e-12 * np.nanmax(np.abs(a_j)))
            assert np.array_equal(np.isnan(a_t), np.isnan(a_j))


def test_rgb_from_frequencies_matches_jax():
    from nifty_tpu.plot import rgb_from_frequencies as j_rgb
    from nifty_tpu_torch.plot import rgb_from_frequencies as t_rgb

    cube = np.random.default_rng(8).uniform(size=(5, 12, 16))
    assert np.array_equal(t_rgb(torch.from_numpy(cube)), j_rgb(cube))
    assert np.array_equal(t_rgb(cube, sat_quantile=0.9, gamma=1.0),
                          j_rgb(cube, sat_quantile=0.9, gamma=1.0))
    with pytest.raises(ValueError):
        t_rgb(cube[0])
