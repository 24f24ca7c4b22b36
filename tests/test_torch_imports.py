"""The port stands alone: no module of ``dgraph_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and its entry points
refuse to run on the CPU unless asked to (this machine has no card)."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dgraph_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "dgraph_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [f"{path.name}:{line} imports {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


def test_scan_sees_the_whole_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("dgraph_tpu_torch/ops/segment.py", "dgraph_tpu_torch/serve/engine.py",
                 "dgraph_tpu_torch/plan.py", "chip_smoke.py"):
        assert must in names
    assert not _forbidden("dgraph_tpu_torch.plan") and _forbidden("dgraph_tpu.plan")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import dgraph_tpu_torch.serve.__main__, dgraph_tpu_torch.ops.local\n"
        "import dgraph_tpu_torch.models, dgraph_tpu_torch.weights\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'dgraph_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda here")
    from dgraph_tpu_torch.config import default_device
    from dgraph_tpu_torch.serve.__main__ import build_serving

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serving()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def test_nvcc_command_targets_hopper():
    from dgraph_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags and "-O3" in flags
    lib = _build.library_path("sorted_segment")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    src = (_build.CSRC_DIR / "sorted_segment.cu").read_text()
    for fn in _build.SIGNATURES["sorted_segment"]:
        assert f"int {fn}(" in src
