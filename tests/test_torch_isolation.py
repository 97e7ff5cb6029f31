"""lft_torch and chip_smoke.py stand apart from JAX and lft_tpu, and the
port's entry points never fall back to the CPU on their own."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "lft_tpu")


def _port_files():
    for root, _, files in os.walk(os.path.join(REPO, "lft_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_files()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path} imports {n}"


def test_importing_every_module_loads_no_jax():
    import lft_torch
    mods = [m.name for m in pkgutil.walk_packages(lft_torch.__path__, "lft_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this test checks the behaviour without a CUDA card")


def test_entry_points_raise_without_card(no_card):
    from lft_torch.device import resolve_device
    from lft_torch.models.lft import init_params, params_from_numpy, param_shapes
    from lft_torch.config import Args
    from lft_torch.utils.checkpoint import load_checkpoint
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(os.path.join(REPO, "examples", "synth_demo",
                                     "LFT_5x5_4x_synth3000.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({k: np.zeros(s, np.float32)
                           for k, s in param_shapes(16, 2).items()})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(0, Args(channels=16, scale_factor=2))
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_card_or_repo(no_card, tmp_path):
    for cwd, script in [(REPO, os.path.join(REPO, "chip_smoke.py")),
                        (tmp_path, str(tmp_path / "chip_smoke.py"))]:
        if cwd == tmp_path:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
