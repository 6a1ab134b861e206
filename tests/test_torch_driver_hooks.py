"""The hooks of the port's ``optimize_kl`` against ``nifty_tpu``'s:
``transitions``, ``inspect_callback`` (one argument or two) and
``terminate_callback`` are called at the same iterations with the same
arguments and stop the loop at the same place; ``export_operator_outputs``
writes ``odir/operator_outputs.h5`` (datasets within 1e-12 of the port's
own export of the final samples) and ``plot_energy_history`` writes
``odir/energy_history.png``, the same files as the JAX package's run."""

import logging
import os

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

RUN = dict(n_samples=2, sample_mode="linear_resample",
           draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=10)),
           kl_kwargs=dict(minimize_kwargs=dict(maxiter=2)))


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _likelihood(mod, arr, data):
    return mod.Gaussian(arr(data), noise_cov_inv=lambda x: x).amend(
        mod.Model(lambda p: p["x"] * 2.0, domain={"x": mod.ShapeWithDtype((4,))}))


def _run(mod, arr, odir, n_total, stop_at, two_arguments, **kw):
    seen = []
    data = np.linspace(-1.0, 1.0, 4)
    lh = _likelihood(mod, arr, data)

    def transitions(i):
        seen.append(("transitions", i))
        if i == 1:
            return lambda s: mod.Samples(pos=jax.tree_util.tree_map(lambda x: 0.5 * x, s.pos)
                                         if mod is jft else {"x": 0.5 * s.pos["x"]},
                                         samples=s._samples, keys=s.keys)
        return None

    def inspect_two(samples, i):
        seen.append(("inspect", i, len(samples)))

    def inspect_one(samples):
        seen.append(("inspect", len(samples)))

    def terminate(samples, state):
        seen.append(("terminate", int(state.nit)))
        return int(state.nit) >= stop_at

    def callback(samples, state):
        seen.append(("callback", int(state.nit)))

    key = jax.random.PRNGKey(1) if mod is jft else 1
    samples, state = mod.optimize_kl(
        lh, {"x": arr(np.ones(4))}, key=key, n_total_iterations=n_total,
        transitions=transitions, callback=callback,
        inspect_callback=inspect_two if two_arguments else inspect_one,
        terminate_callback=terminate, odir=odir, **RUN, **kw)
    return seen, samples, state


@pytest.mark.parametrize("two_arguments", [True, False])
@pytest.mark.parametrize("n_total,stop_at", [(3, 99), (4, 2)])
def test_hooks_run_where_the_jax_packages_do(tmp_path, n_total, stop_at, two_arguments):
    seen_j, _, st_j = _run(jft, jnp.asarray, str(tmp_path / "j"), n_total, stop_at,
                           two_arguments)
    seen_t, _, st_t = _run(jt, torch.from_numpy, str(tmp_path / "t"), n_total, stop_at,
                           two_arguments)
    assert seen_t == seen_j
    assert int(st_t.nit) == int(st_j.nit) == min(n_total, stop_at)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


def test_export_and_energy_history_files(tmp_path):
    h5py = pytest.importorskip("h5py")
    pytest.importorskip("matplotlib")
    fwd = {"sky": lambda s: s["x"] * 2.0}
    odir = tmp_path / "t"
    _, samples, _ = _run(jt, torch.from_numpy, str(odir), 2, 99, True,
                         export_operator_outputs=fwd)
    _run(jft, jnp.asarray, str(tmp_path / "j"), 2, 99, True,
         export_operator_outputs={"sky": lambda s: s["x"] * 2.0})
    files = sorted(os.listdir(odir))
    assert files == sorted(os.listdir(tmp_path / "j"))
    assert files == ["energy_history.png", "last.pkl", "minisanity.txt", "operator_outputs.h5"]
    assert os.path.getsize(odir / "energy_history.png") > 1000
    jt.save_samples_to_hdf5(samples, str(tmp_path / "final.h5"), fwd)
    with h5py.File(odir / "operator_outputs.h5") as f, h5py.File(tmp_path / "final.h5") as g:
        assert sorted(f["sky"]) == ["mean", "samples", "std"]
        for ds in ("mean", "std", "samples"):
            np.testing.assert_allclose(f["sky"][ds][...], g["sky"][ds][...], rtol=0, atol=1e-12)


def test_no_figure_without_plot_energy_history(tmp_path):
    _run(jt, torch.from_numpy, str(tmp_path), 1, 99, True, plot_energy_history=False)
    assert sorted(os.listdir(tmp_path)) == ["last.pkl", "minisanity.txt"]
