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
# the port, chip_smoke.py, and the rank functions the CPU tests spawn
PORT_FILES = sorted((ROOT / "dgraph_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_ranks.py",
    ROOT / "tests" / "torch_replica_ranks.py", ROOT / "tests" / "torch_multihost_worker.py",
    ROOT / "tests" / "torch_serve_ranks.py"]


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
                 "dgraph_tpu_torch/plan.py", "dgraph_tpu_torch/train/loop.py",
                 "dgraph_tpu_torch/train/__main__.py", "dgraph_tpu_torch/train/lm.py",
                 "dgraph_tpu_torch/ops/attention.py", "dgraph_tpu_torch/models/transformer.py",
                 "dgraph_tpu_torch/comm/dist.py", "dgraph_tpu_torch/ops/p2p.py",
                 "dgraph_tpu_torch/analysis/kernel.py", "dgraph_tpu_torch/analysis/lint.py",
                 "dgraph_tpu_torch/analysis/trace.py", "dgraph_tpu_torch/analysis/__main__.py",
                 "dgraph_tpu_torch/analysis/host/__init__.py",
                 "dgraph_tpu_torch/obs/health.py", "dgraph_tpu_torch/utils/cli.py",
                 "dgraph_tpu_torch/native.py", "dgraph_tpu_torch/partition.py",
                 "dgraph_tpu_torch/data/ogbn.py", "dgraph_tpu_torch/data/ogb_raw.py",
                 "dgraph_tpu_torch/data/memmap.py", "dgraph_tpu_torch/sched/ir.py",
                 "dgraph_tpu_torch/wire/spec.py", "dgraph_tpu_torch/wire/codec.py",
                 "dgraph_tpu_torch/wire/dedup.py", "dgraph_tpu_torch/wire/__main__.py",
                 "dgraph_tpu_torch/models/graphcast/mesh.py",
                 "dgraph_tpu_torch/models/graphcast/graph.py",
                 "dgraph_tpu_torch/models/graphcast/model.py",
                 "dgraph_tpu_torch/models/graphcast/__init__.py",
                 "dgraph_tpu_torch/data/weather.py", "dgraph_tpu_torch/train/schedules.py",
                 "dgraph_tpu_torch/train/ema.py", "dgraph_tpu_torch/train/graphcast.py",
                 "dgraph_tpu_torch/train/sampler.py", "dgraph_tpu_torch/comm/multihost.py",
                 "dgraph_tpu_torch/dryrun.py", "tests/torch_replica_ranks.py",
                 "tests/torch_multihost_worker.py", "tests/torch_dist_ranks.py",
                 "tests/torch_serve_ranks.py", "dgraph_tpu_torch/serve/__main__.py",
                 "chip_smoke.py"):
        assert must in names
    assert not _forbidden("dgraph_tpu_torch.plan") and _forbidden("dgraph_tpu.plan")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import dgraph_tpu_torch.serve.__main__, dgraph_tpu_torch.ops.local\n"
        "import dgraph_tpu_torch.models, dgraph_tpu_torch.weights\n"
        "import dgraph_tpu_torch.train.loop, dgraph_tpu_torch.train.__main__\n"
        "import dgraph_tpu_torch.train.lm, dgraph_tpu_torch.ops.kernels\n"
        "import dgraph_tpu_torch.parallel.sequence, dgraph_tpu_torch.train.profile\n"
        "import dgraph_tpu_torch.comm.dist, dgraph_tpu_torch.ops.p2p\n"
        "import dgraph_tpu_torch.analysis.kernel, dgraph_tpu_torch.analysis.lint\n"
        "import dgraph_tpu_torch.analysis.trace, dgraph_tpu_torch.analysis.__main__\n"
        "import dgraph_tpu_torch.analysis.host.__main__, dgraph_tpu_torch.obs.health\n"
        "import dgraph_tpu_torch.utils.cli, dgraph_tpu_torch.native\n"
        "import dgraph_tpu_torch.data.ogbn, dgraph_tpu_torch.data.ogb_raw\n"
        "import dgraph_tpu_torch.data.memmap, dgraph_tpu_torch.sched.__main__\n"
        "import dgraph_tpu_torch.wire.__main__, dgraph_tpu_torch.wire.codec\n"
        "import dgraph_tpu_torch.models.graphcast, dgraph_tpu_torch.data.weather\n"
        "import dgraph_tpu_torch.train.graphcast, dgraph_tpu_torch.train.schedules\n"
        "import dgraph_tpu_torch.train.ema, dgraph_tpu_torch.train.sampler\n"
        "import dgraph_tpu_torch.comm.multihost, dgraph_tpu_torch.dryrun\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_dist_ranks, torch_replica_ranks, torch_serve_ranks\n"
        "import dgraph_tpu_torch.serve.engine\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'dgraph_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda here")
    from dgraph_tpu_torch.config import default_device
    from dgraph_tpu_torch.serve.__main__ import build_serving
    from dgraph_tpu_torch.train.__main__ import Config, build_training

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serving()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_training(Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def test_replica_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda here")
    from dgraph_tpu_torch.comm.multihost import initialize_multihost
    from dgraph_tpu_torch.dryrun import dryrun_multichip

    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_multihost(process_id=0, num_processes=1,
                             coordinator_address="localhost:1")


def test_nvcc_command_targets_hopper():
    from dgraph_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags and "-O3" in flags
    assert set(_build.SOURCES) == set(_build.SIGNATURES) == {"sorted_segment", "sorted_gather",
                                                             "flash_attention", "p2p_transport"}
    for name, source in _build.SOURCES.items():
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
        src = (_build.CSRC_DIR / source).read_text()
        for fn in _build.SIGNATURES[name]:
            assert f"int {fn}(" in src


def test_analysis_host_tier_and_health_are_stdlib_only():
    """The host auditor, the linter, RunHealth and the CLI bridge import
    nothing outside the standard library and the port's own stdlib modules
    (they must run where no torch or card is usable)."""
    code = (
        "import sys\n"
        "import dgraph_tpu_torch.analysis.lint, dgraph_tpu_torch.obs.health\n"
        "import dgraph_tpu_torch.utils.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


WIRE_FILES = sorted((ROOT / "dgraph_tpu_torch" / "wire").glob("*.py"))


@pytest.mark.parametrize("path", WIRE_FILES, ids=lambda p: p.name)
def test_wire_imports_no_ml_dtypes(path):
    """The card's machine has no ``ml_dtypes``: the wire codecs write bf16
    and e4m3 with torch and numpy bit arithmetic."""
    assert not [mod for _, mod in _imports(path) if mod.split(".")[0] == "ml_dtypes"]


def test_wire_codecs_run_without_ml_dtypes_or_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from dgraph_tpu_torch.wire import codec, spec\n"
        "from dgraph_tpu_torch.wire.__main__ import _selftest\n"
        "assert _selftest()['ok']\n"
        "enc, dec = codec.make_wire_transform('fp8', torch.float32)\n"
        "x = torch.randn(4, 6)\n"
        "assert enc(x).shape == (4, 10) and spec.np_encode(x.numpy(), 'fp8').shape == (4, 10)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ml_dtypes', 'dgraph_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
