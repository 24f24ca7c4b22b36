"""The port's contract linter and host-side auditor
(``dgraph_tpu_torch.analysis.lint``, ``dgraph_tpu_torch.analysis.host``) and
the analysis CLI, on the CPU.

Every lint rule fires on its bad fixtures and stays quiet on its good one;
the port and ``chip_smoke.py`` lint clean; the host tier's fixture pairs and
vacuity mutants hold (``host_selftest_failures``) and the port's threaded
host code audits clean, with its real lock edge and guarded fields found.
The ``no-jax-import`` rule agrees with ``tests/test_torch_imports.py``'s
scan on every file of the port. ``no-unpriced-wire-cast`` (the reference's
rule in its torch meaning) holds to ``comm/`` and ``ops/``, sees only
literal narrowing casts in functions that put operands on the wire, and
yields to its pragma; ``wire/``, where narrowing belongs, is out of its
scope. ``python -m dgraph_tpu_torch.analysis
--selftest`` exits 0 with one JSON line, and nonzero on a seeded finding.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from dgraph_tpu_torch import analysis
from dgraph_tpu_torch.analysis import __main__ as cli
from dgraph_tpu_torch.analysis import host, lint

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_RULES = ("no-jax-import", "no-nondeterminism-in-plan", "autograd-function-paired",
              "no-rank-branch-around-collective", "no-unpriced-wire-cast")


@pytest.mark.parametrize("name", PORT_RULES)
def test_rule_fires_on_its_fixtures_and_not_on_clean_code(name):
    fx, r = lint.FIXTURES[name], lint.RULES[name]
    for src in (fx["bad"], *fx["more_bad"]):
        got = r.check(fx["path"], ast.parse(src), src.splitlines())
        assert got and all(f.rule == name for f in got), src
    assert r.check(fx["path"], ast.parse(fx["good"]), fx["good"].splitlines()) == []


def test_lint_selftest_and_pragma():
    assert lint.lint_selftest_failures() == []


def test_the_port_lints_clean():
    rep = lint.run_lint()
    assert rep["ok"], rep["findings"]
    files = {pathlib.Path(p).relative_to(ROOT).as_posix()
             for p in lint.iter_source_files(str(ROOT))}
    assert "chip_smoke.py" in files and "dgraph_tpu_torch/analysis/kernel.py" in files
    assert not any(f.startswith("dgraph_tpu/") for f in files)
    assert rep["files_checked"] == len(files)
    assert set(PORT_RULES) | set(host.HOST_RULES) == set(rep["rules"])


def test_no_jax_import_agrees_with_the_import_scan():
    """The rule flags exactly what test_torch_imports' AST scan forbids:
    nothing in the port, and a seeded import in a copy."""
    import test_torch_imports as imports

    rule = lint.RULES["no-jax-import"]
    for path in imports.PORT_FILES[:-1]:  # the port and chip_smoke.py
        src = path.read_text()
        assert rule.check("dgraph_tpu_torch/x.py", ast.parse(src), src.splitlines()) == []
    for mod in ("jax.numpy", "jaxlib", "flax.linen", "optax", "dgraph_tpu.plan"):
        src = f"import {mod}\n"
        assert rule.check("chip_smoke.py", ast.parse(src), [src]), mod
        assert imports._forbidden(mod)
    assert lint.RULES["no-jax-import"].applies("chip_smoke.py")
    assert not lint.RULES["no-jax-import"].applies("tests/test_torch_dist.py")


def test_rank_branch_rule_sees_through_names_but_not_rank_indexed_values():
    r = lint.RULES["no-rank-branch-around-collective"]
    ok = ("def f(group, peers, cache):\n    land = cache.get(1)\n    if land is not None:\n"
          "        return land\n    land = peers[group.rank]\n    group.barrier()\n")
    assert r.check("dgraph_tpu_torch/ops/p2p.py", ast.parse(ok), ok.splitlines()) == []
    bad = ("import torch.distributed as dist\ndef f(group, x):\n    rank, w = group.rank, 2\n"
           "    while rank > 0:\n        dist.barrier()\n")
    assert r.check("dgraph_tpu_torch/comm/x.py", ast.parse(bad), bad.splitlines())


def test_host_selftest_and_clean_audit():
    assert host.host_selftest_failures() == []
    rep = host.run_host_audit()
    assert rep["ok"], rep["failures"]
    assert rep["files_checked"] == len(host.DURABLE_SCOPE) and rep["chaos_points"] == 0
    assert set(rep["classes"]) == {
        "dgraph_tpu_torch/obs/metrics.py::Metrics",
        "dgraph_tpu_torch/serve/batcher.py::MicroBatcher",
        "dgraph_tpu_torch/serve/engine.py::ServeEngine",
        "dgraph_tpu_torch/serve/registry.py::ModelRegistry"}


@pytest.mark.parametrize("mutant", [
    # torch.save straight into the step directory: no tmp dir, no fsync
    ("_write_synced(os.path.join(tmp, STATE_FILE), lambda f: torch.save(cpu, f))",
     "torch.save(cpu, os.path.join(final, STATE_FILE))"),
    # a bare open of the key file inside the step_path(...) directory
    ("_write_synced(os.path.join(tmp, KEYS_FILE), lambda f: f.write(json.dumps(keys).encode()))",
     "open(os.path.join(step_path(ckpt_dir, step), KEYS_FILE), 'wb').write(b'[]')"),
    # a bare open into the tmp dir: the fsync is gone
    ("_write_synced(os.path.join(tmp, STATE_FILE), lambda f: torch.save(cpu, f))",
     "torch.save(cpu, open(os.path.join(tmp, STATE_FILE), 'wb'))"),
], ids=["torch_save_into_step", "open_into_step_path", "open_into_tmp"])
def test_durable_scope_covers_the_checkpoint_writer(mutant):
    """The checkpoint writer is under the durable-write rules and clean; the
    module's own writes, with their tmp dir or fsync taken away, are RED."""
    path = "dgraph_tpu_torch/train/checkpoint.py"
    assert path in host.DURABLE_SCOPE and path not in host.HOST_SCOPE
    rule = lint.RULES["host-durable-write"]
    assert rule.applies(path) and not rule.applies("dgraph_tpu_torch/train/loop.py")
    src = open(f"{lint.repo_root()}/{path}").read()
    assert rule.check(path, ast.parse(src), src.splitlines()) == []
    old, new = mutant
    assert src.count(old) == 1, "the writer changed shape: update the mutant"
    bad = src.replace(old, new)
    got = rule.check(path, ast.parse(bad), bad.splitlines())
    assert got and {f.rule for f in got} == {"host-durable-write"}, got


def test_host_rules_registered_once_in_one_registry():
    assert analysis.host is host
    assert set(host.HOST_RULES) <= set(lint.RULES)
    catalog = cli._rule_catalog()
    assert [r["name"] for r in catalog["rules"]] == sorted(lint.RULES)


def test_analysis_cli_selftest():
    """``python -m dgraph_tpu_torch.analysis --selftest``: every tier and
    vacuity guard, exit 0, one JSON line."""
    p = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch.analysis", "--selftest"],
                       capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["ok"] and out["failures"] == []
    assert out["kernel_audit"] == {
        "2": {"ok": True, "transports": 12, "num_halo_deltas": 1},
        "4": {"ok": True, "transports": 24, "num_halo_deltas": 3}}
    assert out["lint"]["findings"] == [] and out["host_audit"]["ok"]
    assert out["run_health"]["component"] == "analysis.cli"


def test_analysis_cli_fails_on_a_seeded_finding(tmp_path, capsys):
    """A jax import in a port file makes the lint tier RED and the CLI exit
    nonzero, with the finding in its JSON line."""
    pkg = tmp_path / "dgraph_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text("import jax\n")
    with pytest.raises(SystemExit, match="no-jax-import"):
        cli.main(cli.Config(root=str(tmp_path), host=False, kernel=False))
    out = json.loads(capsys.readouterr().out)
    assert out["lint"]["findings"][0]["path"] == "dgraph_tpu_torch/bad.py"
    assert out["run_health"]["wedge"] == "stage_failure"


def test_wire_cast_rule_scope_and_pragma():
    r = lint.RULES["no-unpriced-wire-cast"]
    bad = ("import torch\ndef send(x, group):\n    y = x.to(torch.uint8)\n"
           "    return all_to_all(y, group)\n")
    assert r.applies("dgraph_tpu_torch/comm/collectives.py")
    assert r.applies("dgraph_tpu_torch/ops/p2p.py")
    assert not r.applies("dgraph_tpu_torch/wire/codec.py")
    assert [f.line for f in r.check("dgraph_tpu_torch/comm/x.py", ast.parse(bad),
                                    bad.splitlines())] == [3]
    # the same cast where nothing goes on the wire, and a cast to a
    # tensor's own dtype beside a collective, are not findings
    quiet = ("import torch\ndef pack(x):\n    return x.to(torch.bfloat16)\n"
             "def send(x, like, group):\n    return all_to_all(x.to(like.dtype), group)\n")
    assert r.check("dgraph_tpu_torch/comm/x.py", ast.parse(quiet), quiet.splitlines()) == []
    allowed = bad.replace("torch.uint8)", "torch.uint8)  # lint: allow(no-unpriced-wire-cast)")
    path = "dgraph_tpu_torch/comm/x.py"
    found = r.check(path, ast.parse(allowed), allowed.splitlines())
    assert found and all(lint._suppressed(allowed.splitlines(), f.line, f.rule) for f in found)
