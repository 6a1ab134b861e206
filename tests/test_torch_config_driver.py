"""The port's ``OptimizeKLConfig`` against ``nifty_tpu``'s: the same
sections give the same ``instantiate()`` (every schedule called at
iterations 0 to 10), section inheritance, ``*section`` references through
builders and ``custom_function`` paths, ``to_file`` round trips, and a
config-driven ``optimize_kl`` is bitwise equal to the port's direct call
with the same arguments (the key: the int seed ``seed``)."""

import configparser
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu import config_driver as jcd  # noqa: E402
from nifty_tpu_torch import config_driver as tcd  # noqa: E402
from test_torch_driver import build  # noqa: E402

torch.set_num_threads(1)
jt.logger.setLevel(logging.WARNING)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


SCHEDULES = """
[optimize_kl]
n_total_iterations = 4
n_samples = 2*2,2*4
sample_mode = linear_resample
seed = 7
flag = yes
off = False
nothing = none
ratio = 2.5e-3
mixed = 1*1,2*0.5,3
names = 2*linear_resample,nonlinear_resample
draw_linear_kwargs = *cg
kl_kwargs = *kl

[base_cg]
maxiter = 20
absdelta = 1e-6

[cg]
base = base_cg
absdelta = 1e-9

[kl]
custom_function = builtins:dict
maxiter = 3*5,10
xtol = 1e-4
"""

# demos/7_config_file.py's text
DEMO7 = """
[optimize_kl]
n_total_iterations = 4
n_samples = 1*1,3*2
draw_linear_kwargs = *cg_conservative
odir = none

[cg_base]
maxiter = 40

[cg_conservative]
base = cg_base
absdelta = 1e-5
"""


def _sections(text):
    cp = configparser.ConfigParser()
    cp.optionxform = str
    cp.read_string(text)
    return {s: dict(cp[s]) for s in cp.sections()}


def _resolved(v):
    """A value of ``instantiate()`` with every schedule called at 0..10."""
    if callable(v):
        return ("schedule", [_resolved(v(i)) for i in range(11)])
    if isinstance(v, dict):
        return {k: _resolved(x) for k, x in v.items()}
    return v


def _builders():
    return {"cg": lambda **kw: dict(cg_kwargs=kw),
            "cg_conservative": lambda **kw: dict(cg_kwargs=kw)}


@pytest.mark.parametrize("text", [SCHEDULES, DEMO7], ids=["schedules", "demo7"])
def test_instantiate_matches_jax(text):
    want = jft.OptimizeKLConfig(_sections(text), builders=_builders())
    got = jt.OptimizeKLConfig(_sections(text), builders=_builders())
    assert _resolved(got.instantiate()) == _resolved(want.instantiate())
    for name in want.sections:
        assert got[name] == want[name]


def test_schedules_and_inheritance():
    kw = jt.OptimizeKLConfig(_sections(SCHEDULES), builders=_builders()).instantiate()
    assert kw["n_total_iterations"] == 4 and kw["seed"] == 7
    assert [kw["n_samples"](i) for i in (0, 1, 2, 3, 100)] == [2, 2, 4, 4, 4]
    assert kw["flag"] is True and kw["off"] is False and kw["nothing"] is None
    assert [kw["mixed"](i) for i in range(5)] == [1, 0.5, 0.5, 3, 3]
    # the schedule syntax is numeric: a list of strings falls back to a string
    assert kw["names"] == "2*linear_resample,nonlinear_resample"
    assert kw["draw_linear_kwargs"] == {"cg_kwargs": {"maxiter": 20, "absdelta": 1e-9}}
    assert kw["kl_kwargs"]["xtol"] == 1e-4
    assert [kw["kl_kwargs"]["maxiter"](i) for i in range(5)] == [5, 5, 5, 10, 10]
    with pytest.raises(ValueError):
        jt.OptimizeKLConfig({"cg": {}})


@pytest.mark.parametrize("value", ["3", "-2", "1.5", "1e-3", "true", "No", "", "None", "abc",
                                   "2*5,3*2", "4,5", "2*x", " 7 "])
def test_parse_value_matches_jax(value):
    got, want = tcd.parse_value(value), jcd.parse_value(value)
    assert got == want and type(got) is type(want)


def test_to_file_round_trips(tmp_path):
    src = tmp_path / "a.ini"
    src.write_text(SCHEDULES)
    a = jt.OptimizeKLConfig.from_file(str(src), builders=_builders())
    a.to_file(str(tmp_path / "b.ini"))
    b = jt.OptimizeKLConfig.from_file(str(tmp_path / "b.ini"), builders=_builders())
    assert b.sections == a.sections
    assert _resolved(b.instantiate()) == _resolved(a.instantiate())
    # the JAX package reads the port's file the same
    c = jft.OptimizeKLConfig.from_file(str(tmp_path / "b.ini"), builders=_builders())
    assert _resolved(c.instantiate()) == _resolved(b.instantiate())


RUN = """
[optimize_kl]
n_total_iterations = 3
n_samples = 1*1,2*2
sample_mode = *modes
draw_linear_kwargs = *draw
nonlinearly_update_kwargs = *nonlinear
kl_kwargs = *kl
residual_map = vmap
seed = 5

[modes]
switch = 2

[draw]
maxiter = 5

[nonlinear]
xtol = 1e-3
maxiter = 2

[kl]
xtol = 1e-4
maxiter = 3
"""


def _run_builders():
    return {
        "modes": lambda switch: (
            lambda i: "nonlinear_resample" if i >= switch else "linear_resample"),
        "draw": lambda **kw: dict(cg_kwargs=kw),
        "nonlinear": lambda **kw: dict(minimize_kwargs=dict(kw, cg_kwargs=dict(maxiter=5))),
        "kl": lambda **kw: dict(minimize_kwargs=dict(kw, cg_kwargs=dict(maxiter=5))),
    }


def test_config_driven_optimize_kl_is_bitwise_the_direct_call():
    cf = build(jt, (16, 16))
    rng = np.random.default_rng(2)
    data = torch.from_numpy(rng.standard_normal(cf.target.shape) * 0.1)
    lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / 0.01).amend(cf)
    pos = jt.from_numpy({k: rng.standard_normal(v.shape) for k, v in cf.domain.items()})
    cfg = jt.OptimizeKLConfig(_sections(RUN), builders=_run_builders())
    s_cfg, st_cfg = cfg.optimize_kl(lh, pos)
    s_dir, st_dir = jt.optimize_kl(
        lh, pos, key=5, n_total_iterations=3, n_samples=lambda i: 1 if i < 1 else 2,
        sample_mode=lambda i: "nonlinear_resample" if i >= 2 else "linear_resample",
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
            xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=5))),
        residual_map="vmap")
    assert st_cfg.nit == st_dir.nit == 3 and len(s_cfg) == len(s_dir) == 4
    assert float(st_cfg.minimization_state.fun) == float(st_dir.minimization_state.fun)
    for k in s_dir.pos:
        assert torch.equal(s_cfg.pos[k], s_dir.pos[k])
        assert torch.equal(s_cfg._samples[k], s_dir._samples[k])
    # an explicit key replaces the seed, an override replaces a value
    s_key, _ = cfg.optimize_kl(lh, pos, key=5, n_total_iterations=1)
    s_one, _ = cfg.optimize_kl(lh, pos, n_total_iterations=1)
    for k in s_one.pos:
        assert torch.equal(s_key.pos[k], s_one.pos[k])
