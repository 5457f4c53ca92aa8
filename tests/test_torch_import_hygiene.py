"""The PyTorch port stands alone: no module of ``rl_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax or anything of ``rl_tpu``, and
importing every module neither pulls JAX in nor initialises CUDA."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "rl_tpu"}


def _port_files():
    return sorted((ROOT / "rl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_reference():
    files = _port_files()
    assert len(files) > 10
    bad = [
        f"{p.relative_to(ROOT)}: {name}"
        for p in files
        for name in _imported_roots(p)
        if name in FORBIDDEN
    ]
    assert not bad, bad


def test_importing_every_module_pulls_in_no_jax_and_no_cuda():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rl_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(rl_tpu_torch.__path__, 'rl_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12
