"""The port's public API and module list against ``nifty_tpu``'s: every
name that ``nifty_tpu/__init__.py`` exports exists in ``nifty_tpu_torch``,
and every module of the JAX package has a counterpart at the same relative
path, apart from the ones listed here as left out on purpose.  The source
of the JAX package is read, not imported."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import nifty_tpu_torch as jt  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT = REPO / "nifty_tpu", REPO / "nifty_tpu_torch"

#: Names of ``nifty_tpu/__init__.py`` with no counterpart in the port, and
#: why.  None: every exported name has one.
LEFT_OUT_NAMES = {}

#: Modules of the JAX package with no counterpart in the port, and why.
LEFT_OUT_MODULES = {
    "ops/pallas_gather.py": "the TPU's Pallas kernels; the port's are CUDA (ops/bin_gather.py)",
    "ops/linear_prim.py": "a JAX primitive for self-adjoint linear maps; autograd needs none",
    "native/__init__.py": "the ctypes loader of the JAX package's HEALPix core; the port "
                          "builds its own copy (ops/healpix.py, csrc/healpix.cpp)",
}

#: The modules this slice added, which the no-jax check must cover.
NEW_MODULES = ("config_driver.py", "instrumentation.py", "plot.py", "pytree_string.py",
               "misc.py", "num/unique.py")


def _exported_names(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return sorted(names)


@pytest.mark.parametrize("name", _exported_names(JAX_PKG / "__init__.py"))
def test_every_exported_name_has_a_counterpart(name):
    if name in LEFT_OUT_NAMES:
        assert not hasattr(jt, name), f"{name} is ported: take it off the list"
        return
    assert hasattr(jt, name), f"nifty_tpu_torch does not export {name}"


def test_version_is_the_jax_packages():
    tree = ast.parse((JAX_PKG / "__init__.py").read_text())
    want = [ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
            and any(getattr(t, "id", None) == "__version__" for t in n.targets)]
    assert [jt.__version__] == want


def _modules(root):
    return {str(p.relative_to(root)) for p in root.rglob("*.py") if "__pycache__" not in p.parts}


def test_every_module_has_a_counterpart():
    missing = _modules(JAX_PKG) - _modules(PORT)
    assert missing == set(LEFT_OUT_MODULES), sorted(missing ^ set(LEFT_OUT_MODULES))


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_are_under_the_no_jax_check(module):
    import test_torch_no_jax as nj

    assert (PORT / module).exists()
    params = [m for m in nj.test_no_source_imports_jax.pytestmark if m.name == "parametrize"]
    assert PORT / module in params[0].args[1]
