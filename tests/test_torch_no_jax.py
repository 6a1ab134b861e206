"""The port stands alone: ``import nifty_tpu_torch`` loads no jax module, no
source file of the package (nor ``chip_smoke.py``) imports jax, and
``chip_smoke.py`` fails without a CUDA card and prints no result."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "nifty_tpu_torch"
_JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)


def _run(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, *code_or_args], capture_output=True, text=True,
        timeout=120, env=env, **kw,
    )


def test_import_loads_no_jax_module():
    code = (
        "import sys, nifty_tpu_torch, nifty_tpu_torch.optimize_kl;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'nifty_tpu' or m.startswith('nifty_tpu.')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = _run(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [REPO / "chip_smoke.py"]
), ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax(path):
    src = path.read_text()
    assert not _JAX_IMPORT.search(src), f"{path} imports jax"
    assert not re.search(r"^\s*(import|from)\s+nifty_tpu(\.|\s|$)", src, re.MULTILINE)


def test_chip_smoke_fails_without_a_card(tmp_path):
    proc = _run([str(REPO / "chip_smoke.py")], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
