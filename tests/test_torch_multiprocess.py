"""The port across processes: worlds of ranks started by
``nifty_tpu_torch.parallel.run_world`` (gloo on the CPU), against one
process.  Counterpart of ``tests/test_multiprocess.py`` (one field
sharded across two processes equals the single-process update), with the
sharded checkpoint written on two ranks and resumed on one and on four,
``kl_reduce``, and the launcher's own contract: a rank that fails or
hangs fails the world, at the world's timeout.

The ranks run ``tests/torch_mesh_worker.py`` (no jax); each world
computes every case it serves at once, in one module fixture.
"""

import importlib.util
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as W  # noqa: E402

from nifty_tpu_torch.parallel import run_world  # noqa: E402

#: seconds a world may take; a rank stuck in a collective fails at 120 s
WORLD_TIMEOUT = 300
CKPT_BUDGETS = (10, 5, 3, 10)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    torch.set_num_threads(1)
    yield
    config.update("device", old)


def _problem(n, seed=42):
    data = np.random.default_rng(seed).normal(size=(n, n))
    cf = W.correlated_field((n, n), None, distributed=False)
    rng = np.random.default_rng(1)
    return data, {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()}


def _record(seed):
    """The noise of a ``HostKey(seed)`` update of the 64^2 problem (a cheap
    run requests every draw a full one does), as a replay table."""
    import nifty_tpu_torch as jt

    class Recording:
        def __init__(self, key, path=()):
            self.key, self.path = key, path

        def split(self, num):
            return [Recording(k, self.path + (i,)) for i, k in enumerate(self.key.split(num))]

        def normal(self, primals, device=None):
            out = self.key.normal(primals, device="cpu")
            table[self.path] = jt.to_numpy(out)
            return out

    table = {}
    data, pos = _problem(64)
    lh = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x).amend(
        W.correlated_field((64, 64), None, distributed=False))
    opt = jt.OptimizeVI(lh, n_total_iterations=1)
    state = opt.init_state(Recording(jt.HostKey(seed)), **W._vi_kwargs(
        (1, 1, 1, 1), 1, 2, "linear_resample"))
    opt.update(jt.Samples(pos=jt.from_numpy(pos)), state)
    return table


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two worlds of two ranks: the multiprocess update and the checkpoint
    writer; worlds of four: the checkpoint resumed on 4 x 1 and
    ``kl_reduce`` on 2 x 2; the single-process runs in this process."""
    odir = str(tmp_path_factory.mktemp("ckpt"))
    data64, pos64 = _problem(64)
    table = _record(7)
    update = dict(data=data64, pos=pos64, key_table=table, sample_mode="linear_resample",
                  nl_maxiter=0, budgets=(200, 100, 30, 150))
    data32, pos32 = _problem(32)
    ckpt = dict(data=data32, pos=pos32, seed=11, budgets=CKPT_BUDGETS, n_samples=4)
    # the HDF5 export needs h5py (the card's machine has none)
    export = dict(data=data32, pos=pos32, seed=13, budgets=CKPT_BUDGETS, n_samples=2)
    exports = {w: os.path.join(odir, f"export_{w}") for w in ("1x1", "1x2", "2x1")}
    has_h5py = importlib.util.find_spec("h5py") is not None
    t0 = time.perf_counter()
    two = run_world(W.run_cases, 2, args=([
        ("update", "vi_update_case", dict(update, samples=1, field=2)),
        ("write", "checkpoint_write_case", dict(ckpt, samples=1, field=2, odir=odir)),
    ] + [(f"export_{w}", "export_case", dict(export, samples=int(w[0]), field=int(w[2]),
                                            odir=exports[w]))
         for w in ("1x2", "2x1") if has_h5py],), timeout=WORLD_TIMEOUT, threads=1)
    dirs = {}
    for label in ("1x1", "4x1"):
        dirs[label] = os.path.join(odir, label)
        shutil.copytree(os.path.join(odir, "last_ckpt"), os.path.join(dirs[label], "last_ckpt"))
    four = run_world(W.run_cases, 4, args=([
        ("resume", "checkpoint_resume_case", dict(ckpt, samples=4, field=1, odir=dirs["4x1"])),
        ("kl_reduce", "kl_reduce_case", dict(data=data32, pos=pos32, seed=5, samples=2, field=2,
                                             budgets=CKPT_BUDGETS)),
    ],), timeout=WORLD_TIMEOUT, threads=1)
    worlds_s = time.perf_counter() - t0
    one = W.run_cases([
        ("update", "vi_update_case", dict(update, samples=1, field=1)),
        ("resume", "checkpoint_resume_case", dict(ckpt, samples=1, field=1, odir=dirs["1x1"])),
    ] + ([("export_1x1", "export_case", dict(export, samples=1, field=1, odir=exports["1x1"]))]
         if has_h5py else []))
    return dict(two=two, four=four, one=one, odir=odir, worlds_s=worlds_s, exports=exports)


def test_two_process_field_mesh_matches_single_process(runs):
    """``test_two_process_mesh_matches_single_process``: the linear update
    with the field sharded across two processes, against one process."""
    two, one = runs["two"][0]["update"], runs["one"]["update"]
    np.testing.assert_allclose(two["fun"], one["fun"], rtol=1e-8)
    for k in one["samples"]:
        np.testing.assert_allclose(two["samples"][k], one["samples"][k], atol=5e-5,
                                   err_msg=f"cross-process mismatch in {k}")


def test_every_rank_holds_the_same_result(runs):
    a, b = (r["update"] for r in runs["two"])
    assert a["fun"] == b["fun"]
    for k in a["samples"]:
        np.testing.assert_array_equal(a["samples"][k], b["samples"][k])


def test_sharded_checkpoint_layout(runs):
    files = sorted(os.listdir(os.path.join(runs["odir"], "last_ckpt")))
    assert files == ["manifest.pt", "shard_s0_f0.pt", "shard_s0_f1.pt"]
    assert "minisanity.txt" in os.listdir(runs["odir"])


@pytest.mark.parametrize("world", ["1x1", "4x1"])
def test_checkpoint_resumes_bitwise_on_another_world(runs, world):
    """Written on two ranks (1 x 2), resumed on one and on four (4 x 1):
    the resumed third iteration has the bits of the one continued in
    memory (``deterministic_reductions``)."""
    mem = runs["two"][0]["write"]["three"]
    got = runs["one"]["resume"] if world == "1x1" else runs["four"][0]["resume"]
    assert got["nit"] == mem["nit"] == 3
    assert got["fun"] == mem["fun"]
    for part in ("pos", "samples"):
        for k in mem[part]:
            np.testing.assert_array_equal(got[part][k], mem[part][k])


def test_kl_reduce_is_the_kl_stages_reduction(runs):
    out = runs["four"][0]["kl_reduce"]
    assert out["calls"] > 0
    assert out["counted"]["fun"] == out["default"]["fun"]
    for k in out["default"]["samples"]:
        np.testing.assert_array_equal(out["counted"]["samples"][k],
                                      out["default"]["samples"][k])


def _h5(path):
    import h5py

    with h5py.File(path) as f:
        return {f"{g}/{d}": f[g][d][()] for g in f for d in f[g]}


@pytest.mark.parametrize("world", ["1x2", "2x1"])
def test_operator_outputs_exported_from_several_ranks(runs, world):
    """``optimize_kl(export_operator_outputs=)`` on a world of two ranks
    (the field sharded, or the samples): rank 0 writes
    ``operator_outputs.h5`` with the datasets of one rank, bit for bit
    under ``deterministic_reductions``: the field (a slab a rank on the
    field mesh), and a table of one axis and one of two that every rank
    holds whole; ``save_samples_to_hdf5`` of the same samples without it
    within 1e-12.  A CPU test: the card's machine has no h5py."""
    pytest.importorskip("h5py")
    got_dir, want_dir = runs["exports"][world], runs["exports"]["1x1"]
    for r in runs["two"]:
        assert "operator_outputs.h5" in r[f"export_{world}"][0]
    got = _h5(os.path.join(got_dir, "operator_outputs.h5"))
    want = _h5(os.path.join(want_dir, "operator_outputs.h5"))
    assert sorted(got) == sorted(want) == [
        "amplitude/mean", "amplitude/samples", "amplitude/std",
        "field/mean", "field/samples", "field/std",
        "outer/mean", "outer/samples", "outer/std"]
    assert want["outer/samples"].ndim == 3
    assert want["field/samples"].shape == (4, 32, 32)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = _h5(os.path.join(got_dir, "direct.h5"))
    want = _h5(os.path.join(want_dir, "direct.h5"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-12 * np.abs(want[k]).max(), err_msg=k)


def test_export_raises_where_an_output_layout_is_unknown(runs):
    """On a field axis of two ranks an output that is neither a slab of a
    field-sharded leaf nor the same on every rank is not written: a field
    cut to one axis, and zeros of a slab's shape, raise on both ranks.
    With one field rank (1 x 1, 2 x 1) both are written."""
    pytest.importorskip("h5py")
    for r in runs["two"]:
        errors = r["export_1x2"][1]
        assert "different on the field ranks" in errors["column"]
        assert "the same on every field rank" in errors["zeros"]
        assert r["export_2x1"][1] == {"column": None, "zeros": None}
    assert runs["one"]["export_1x1"][1] == {"column": None, "zeros": None}


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        run_world(W.run_cases, 2, args=([("f", "fail_case", dict(rank=1))],), timeout=60,
                  collective_timeout=30)


def test_a_hanging_world_fails_at_its_timeout():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="did not finish"):
        run_world(W.run_cases, 2, args=([("s", "sleep_case", dict(rank=1, seconds=600))],),
                  timeout=10, collective_timeout=60)
    assert time.perf_counter() - t0 < 40
