"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, the port imports in a
process where JAX cannot be imported, and its entry points raise instead
of falling back to the CPU when there is no card and no explicit CPU
request."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path}: imports {bad}"


_BLOCKER = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in %r):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print(len(mods))
""" % (FORBIDDEN,)


def test_port_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKER],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n = sum(1 for _ in pkgutil.walk_packages(repro_torch.__path__,
                                             "repro_torch."))
    assert int(out.stdout.split()[-1]) == n


@pytest.fixture
def no_card(monkeypatch):
    """Decide inside the test that there is no card, whatever the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    cfg = get_config("qwen3-4b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(cfg, {})
    with pytest.raises(RuntimeError):
        build_model(cfg, device="cuda")


def test_tuner_raises_without_a_card(no_card, tmp_path, monkeypatch):
    """The tuner's wall-clock entry points time the card: without one and
    without device='cpu' they raise before measuring anything."""
    from repro_torch.tune import tune_compiled, tune_kernel
    from repro_torch.tune.runners import time_callable
    path = tmp_path / "cache.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(path))
    for call in (lambda: tune_kernel("dae_merge"),
                 lambda: tune_kernel("dae_merge", device="cuda"),
                 lambda: tune_compiled("gather"),
                 lambda: time_callable(lambda: None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not path.exists()


def test_explicit_cpu_request_runs_on_the_cpu(no_card):
    cfg = get_config("qwen3-4b", smoke=True)
    bundle = build_model(cfg, device="cpu")
    assert bundle.device == torch.device("cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" for p in params.parameters())
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env={"CUDA_VISIBLE_DEVICES": "",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
