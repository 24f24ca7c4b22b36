"""Contract linter: stdlib-``ast`` rules for the port's cross-layer contracts —
counterpart of ``dgraph_tpu/analysis/lint.py``, aimed at
``dgraph_tpu_torch/`` and ``chip_smoke.py``.

The rule engine is the reference's (:class:`Rule`, :data:`RULES`,
:func:`rule`, :func:`path_matcher`, the ``# lint: allow(<rule>)`` pragma,
:func:`lint_file`, :func:`run_lint`, :func:`iter_source_files`). The rules
are the reference's that have a meaning in PyTorch:

- ``no-jax-import`` (the reference's ``jax-free-module``, widened to the
  whole port): no import of ``jax``, ``jaxlib``, ``flax``, ``optax`` or
  ``dgraph_tpu`` anywhere in the port or ``chip_smoke.py``, in any scope —
  the port stands alone, and importing any ``dgraph_tpu`` module loads jax.
  ``tests/test_torch_imports.py`` makes the same scan.
- ``no-nondeterminism-in-plan``: plan and partition builds are
  deterministic in (graph, seed): no unseeded RNG, no wall-clock reads.
- ``autograd-function-paired`` (the reference's ``custom-vjp-paired``):
  every ``torch.autograd.Function`` subclass defines both ``forward`` and
  ``backward`` — an unpaired one runs forward and fails only when somebody
  differentiates through it.
- ``no-rank-branch-around-collective`` (the reference's
  ``no-rank-branch-in-trace``): no collective (a ``torch.distributed``
  collective, a group's ``barrier`` or ``all_gather_object``, the p2p
  transport) under a branch on this rank's identity, or after a
  rank-dependent early exit, in ``comm/`` and ``ops/p2p.py``. A rank that
  skips a collective its peers enter hangs them: it never errors.
- ``no-unpriced-wire-cast`` (``dgraph_tpu/analysis/lint.py:852-925``, in
  its torch meaning): in ``comm/`` and ``ops/``, a function that calls a
  ``torch.distributed`` collective or point-to-point op, or the p2p
  transport, narrows no tensor to a literal dtype (``.to(torch.bfloat16)``,
  ``float16``, ``float8_*``, ``int8`` or ``uint8``; ``.bfloat16()``,
  ``.half()``): narrowing a wire payload is :mod:`dgraph_tpu_torch.wire`'s
  job, whose formats are priced and verified.

The reference's rules tied to jit tracing or ``shard_map``
(``no-config-read-in-trace``, ``no-span-in-trace``,
``named-scope-on-collectives``, ``no-unchecked-shard-map``,
``no-monolithic-plan-pickle``) wait for the port modules they guard
(ROADMAP).

Adding a rule: write ``check(path, tree, lines) -> list[Finding]``,
decorate with :func:`rule`, and add a fixture pair to :data:`FIXTURES` (a
snippet that must fire and one that must not).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Optional

_PRAGMA = re.compile(r"#\s*lint:\s*allow\(([a-z0-9_,\- ]+)\)")

PORT = "dgraph_tpu_torch/"
SCRIPTS = ("chip_smoke.py",)


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Rule:
    name: str
    description: str
    applies: Callable[[str], bool]  # repo-relative posix path -> bool
    check: Callable[[str, ast.AST, list], list]  # (relpath, tree, lines)
    scope: str = ""  # human-readable applies-to, printed by --list_rules


RULES: dict = {}


def rule(name: str, description: str, applies, scope: str = ""):
    """Register a rule. ``applies`` is a predicate over the repo-relative
    posix path (use :func:`path_matcher` for prefix sets)."""

    def deco(fn):
        RULES[name] = Rule(name, description, applies, fn, scope)
        return fn

    return deco


def path_matcher(*prefixes: str):
    def match(relpath: str) -> bool:
        return any(relpath.startswith(p) for p in prefixes)

    return match


def _suppressed(lines: list, lineno: int, rule_name: str) -> bool:
    """True when the finding's line (or the one above) carries
    ``# lint: allow(<rule>)`` for this rule."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _PRAGMA.search(lines[ln - 1])
            if m and rule_name in [s.strip() for s in m.group(1).split(",")]:
                return True
    return False


def _dotted(node) -> str:
    """Best-effort dotted name of an expression (``a.b.c`` -> "a.b.c")."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _last_segment(node) -> str:
    d = _dotted(node)
    return d.rsplit(".", 1)[-1] if d else ""


# ---------------------------------------------------------------------------
# no-jax-import
# ---------------------------------------------------------------------------

FORBIDDEN_TOPS = ("jax", "jaxlib", "flax", "optax", "dgraph_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_TOPS


@rule(
    "no-jax-import",
    "no import of jax, jaxlib, flax, optax or dgraph_tpu in any scope of the port or "
    "chip_smoke.py (import statements and importlib.import_module of a literal name): "
    "the port stands alone, and any dgraph_tpu module loads jax",
    path_matcher(PORT, *SCRIPTS),
    scope="dgraph_tpu_torch/, chip_smoke.py",
)
def check_no_jax_import(relpath: str, tree: ast.AST, lines: list):
    findings = []
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods = [node.module]
        elif (isinstance(node, ast.Call)
              and _last_segment(node.func) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            mods = [node.args[0].value]
        for mod in mods:
            if _forbidden(mod):
                findings.append(Finding(
                    "no-jax-import", relpath, node.lineno,
                    f"import of {mod!r}: the port imports neither jax nor the JAX package "
                    f"(only tests import both)",
                ))
    return findings


# ---------------------------------------------------------------------------
# no-nondeterminism-in-plan
# ---------------------------------------------------------------------------

SEEDED_RNG_CONSTRUCTORS = frozenset({
    "default_rng", "Generator", "RandomState", "SeedSequence", "Random",
})
WALL_CLOCK_CALLS = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic", "now",
    "utcnow", "today",
})


@rule(
    "no-nondeterminism-in-plan",
    "plan/partition builds must be deterministic in (graph, seed): no unseeded RNG and "
    "no wall-clock reads",
    path_matcher(PORT + "plan.py", PORT + "partition.py"),
    scope="plan.py, partition.py",
)
def check_plan_determinism(relpath: str, tree: ast.AST, lines: list):
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        last = dotted.rsplit(".", 1)[-1] if dotted else ""
        if ".random." in f".{dotted}" or dotted.startswith("random."):
            if last in SEEDED_RNG_CONSTRUCTORS:
                if not node.args and not node.keywords:
                    findings.append(Finding(
                        "no-nondeterminism-in-plan", relpath, node.lineno,
                        f"'{dotted}()' with no seed in a plan-build path",
                    ))
            else:
                findings.append(Finding(
                    "no-nondeterminism-in-plan", relpath, node.lineno,
                    f"unseeded module-level RNG call '{dotted}' in a plan-build path "
                    f"(use a seeded default_rng)",
                ))
        elif last in WALL_CLOCK_CALLS and dotted.split(".", 1)[0] in ("time", "datetime", "dt"):
            findings.append(Finding(
                "no-nondeterminism-in-plan", relpath, node.lineno,
                f"wall-clock read '{dotted}' in a plan-build path",
            ))
    return findings


# ---------------------------------------------------------------------------
# autograd-function-paired
# ---------------------------------------------------------------------------


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any(_dotted(b) in ("torch.autograd.Function", "autograd.Function", "Function")
               for b in cls.bases)


@rule(
    "autograd-function-paired",
    "every torch.autograd.Function subclass defines both forward and backward (an "
    "unpaired one fails only when somebody differentiates through it)",
    path_matcher(PORT),
    scope="dgraph_tpu_torch/",
)
def check_autograd_function_paired(relpath: str, tree: ast.AST, lines: list):
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef) or not _is_autograd_function(node):
            continue
        defined = {m.name for m in node.body if isinstance(m, ast.FunctionDef)}
        missing = [m for m in ("forward", "backward") if m not in defined]
        if missing:
            findings.append(Finding(
                "autograd-function-paired", relpath, node.lineno,
                f"autograd Function {node.name!r} defines no {' and no '.join(missing)}",
            ))
    return findings


# ---------------------------------------------------------------------------
# no-rank-branch-around-collective
# ---------------------------------------------------------------------------

# calls every rank of a group must make together
COLLECTIVE_CALLS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
    "all_to_all_single", "broadcast", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "gather", "scatter", "barrier", "monitored_barrier",
    "all_gather_object", "broadcast_object_list", "new_group",
    "p2p_transport", "p2p_transport_mutant", "land_tiles", "landing_buffer",
})
RANK_ENV_VARS = frozenset({"RANK", "LOCAL_RANK"})
EXITS = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def _env_rank_read(node: ast.AST) -> bool:
    """``os.environ["RANK"]``, ``os.environ.get("RANK")`` or
    ``os.getenv("RANK")`` (or ``LOCAL_RANK``)."""
    if isinstance(node, ast.Subscript):
        return (_dotted(node.value) == "os.environ" and isinstance(node.slice, ast.Constant)
                and node.slice.value in RANK_ENV_VARS)
    return (isinstance(node, ast.Call) and _dotted(node.func) in ("os.environ.get", "os.getenv")
            and bool(node.args) and isinstance(node.args[0], ast.Constant)
            and node.args[0].value in RANK_ENV_VARS)


def _is_rank_value(val: ast.AST, tainted: set) -> bool:
    """True when ``val`` IS this process's rank, or arithmetic on it: an
    ``x.rank`` attribute, ``get_rank()``, a rank environment variable,
    ``int(...)`` of one, a name assigned one — not a value merely computed
    with the rank (``peers[group.rank]``)."""
    if isinstance(val, (ast.BinOp, ast.UnaryOp)):
        return any(_is_rank_value(v, tainted) for v in ast.iter_child_nodes(val)
                   if isinstance(v, ast.expr))
    if isinstance(val, ast.Call) and _last_segment(val.func) == "int" and val.args:
        return _is_rank_value(val.args[0], tainted)
    if isinstance(val, ast.Name):
        return val.id in tainted
    if isinstance(val, ast.Attribute):
        return val.attr == "rank"
    if isinstance(val, ast.Call) and _last_segment(val.func) == "get_rank":
        return True
    return _env_rank_read(val)


def _reads_rank(expr: ast.AST, tainted: set) -> bool:
    """True when ``expr`` reads this process's rank anywhere inside."""
    return any(_is_rank_value(sub, tainted) for sub in ast.walk(expr))


def _rank_names(fn: ast.AST) -> set:
    """Names assigned (to a fixpoint) the rank itself (:func:`_is_rank_value`);
    a tuple assignment pairs its targets with its values."""
    tainted: set = set()
    for _ in range(4):
        grew = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                pairs = (zip(t.elts, node.value.elts)
                         if isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple)
                         and len(t.elts) == len(node.value.elts) else [(t, node.value)])
                for tgt, val in pairs:
                    if (isinstance(tgt, ast.Name) and tgt.id not in tainted
                            and _is_rank_value(val, tainted)):
                        tainted.add(tgt.id)
                        grew = True
        if not grew:
            break
    return tainted


def _collectives_in(nodes) -> list:
    return [(sub.lineno, _last_segment(sub.func)) for n in nodes for sub in ast.walk(n)
            if isinstance(sub, ast.Call) and _last_segment(sub.func) in COLLECTIVE_CALLS]


@rule(
    "no-rank-branch-around-collective",
    "no torch.distributed collective, group barrier, all_gather_object or p2p transport "
    "under a branch on this rank's identity, or after a rank-dependent early exit: a "
    "rank that skips a collective its peers enter deadlocks them",
    path_matcher(PORT + "comm/", PORT + "ops/p2p.py"),
    scope="comm/, ops/p2p.py",
)
def check_rank_branch_around_collective(relpath: str, tree: ast.AST, lines: list):
    findings = []
    seen = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        tainted = _rank_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                continue
            if not _reads_rank(node.test, tainted):
                continue
            body = node.body if isinstance(node.body, list) else [node.body]
            orelse = node.orelse if isinstance(node.orelse, list) else [node.orelse]
            hits = _collectives_in(body + orelse)
            if isinstance(node, ast.If) and body and isinstance(body[-1], EXITS):
                # a rank-dependent early exit skips what follows in its block
                for block in (getattr(p, f, None) for p in ast.walk(fn)
                              for f in ("body", "orelse", "finalbody")):
                    if isinstance(block, list) and node in block:
                        hits += _collectives_in(block[block.index(node) + 1:])
            for line, name in hits:
                if (line, name) in seen:
                    continue
                seen.add((line, name))
                findings.append(Finding(
                    "no-rank-branch-around-collective", relpath, line,
                    f"collective {name!r} under the rank-dependent branch at line "
                    f"{node.lineno} in {fn.name!r}: the ranks that skip it leave the others "
                    f"waiting in it forever",
                ))
    return findings


# ---------------------------------------------------------------------------
# no-unpriced-wire-cast
# ---------------------------------------------------------------------------

# dtypes narrower than fp32 whose literal spelling in a cast marks a
# deliberate narrowing (a cast to ``x.dtype`` or a widening never matches)
NARROW_DTYPES = frozenset({
    "bfloat16", "float16", "half", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
    "float8_e5m2fnuz", "int8", "uint8",
})
# methods that narrow by their name alone
NARROW_METHODS = frozenset({"bfloat16", "half"})
# calls that put an operand on the wire: the collectives, torch.distributed's
# point-to-point ops, and the p2p transport
WIRE_EXCHANGE_CALLS = COLLECTIVE_CALLS | frozenset({
    "isend", "irecv", "send", "recv", "batch_isend_irecv", "P2POp",
})


def _narrow_cast(call: ast.Call) -> Optional[str]:
    """The narrow dtype a call casts to literally: ``.to(torch.bfloat16)``
    (or ``dtype=``), ``.bfloat16()``, ``.half()``; else None."""
    last = _last_segment(call.func)
    if last in NARROW_METHODS and isinstance(call.func, ast.Attribute) and not call.args:
        return last
    if last != "to":
        return None
    for arg in list(call.args) + [k.value for k in call.keywords if k.arg == "dtype"]:
        name = _last_segment(arg) if isinstance(arg, (ast.Attribute, ast.Name)) else None
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
        if name in NARROW_DTYPES:
            return name
    return None


@rule(
    "no-unpriced-wire-cast",
    "no literal dtype-narrowing cast (.to(torch.bfloat16 | float16 | float8_* | int8 | "
    "uint8), .bfloat16(), .half()) in a function that puts operands on the wire (a "
    "torch.distributed collective or point-to-point op, or the p2p transport): an ad-hoc "
    "cast ships bytes no wire format prices — narrowing wire payloads is "
    "dgraph_tpu_torch.wire's job",
    path_matcher(PORT + "comm/", PORT + "ops/"),
    scope="comm/, ops/",
)
def check_unpriced_wire_cast(relpath: str, tree: ast.AST, lines: list):
    findings = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        issues = [sub.lineno for sub in ast.walk(fn) if isinstance(sub, ast.Call)
                  and _last_segment(sub.func) in WIRE_EXCHANGE_CALLS]
        if not issues:
            continue
        for sub in ast.walk(fn):
            dt = _narrow_cast(sub) if isinstance(sub, ast.Call) else None
            if dt:
                findings.append(Finding(
                    "no-unpriced-wire-cast", relpath, sub.lineno,
                    f"literal narrowing cast to {dt!r} inside {fn.name!r} (line {fn.lineno}), "
                    f"which puts operands on the wire (exchange call at line {issues[0]}): "
                    f"those bytes ride no priced wire format — encode through "
                    f"dgraph_tpu_torch.wire (make_wire_transform)",
                ))
    return findings


# ---------------------------------------------------------------------------
# fixtures: every rule must fire on `bad` and not on `good`
# ---------------------------------------------------------------------------

FIXTURES = {
    "no-jax-import": {
        "path": "dgraph_tpu_torch/ops/x.py",
        "bad": "def poison(tree):\n    import jax\n    return jax.tree.map(id, tree)\n",
        "good": "import torch\n\ndef poison(tree):\n    return tree\n",
        "more_bad": (
            "from dgraph_tpu.plan import build_edge_plan\n",
            "import importlib\nm = importlib.import_module('optax')\n",
        ),
    },
    "no-nondeterminism-in-plan": {
        "path": "dgraph_tpu_torch/plan.py",
        "bad": "import numpy as np\ndef build(edges):\n    return np.random.permutation(edges)\n",
        "good": (
            "import numpy as np\ndef build(edges, seed):\n"
            "    return np.random.default_rng(seed).permutation(edges)\n"
        ),
        "more_bad": ("import time\ndef build(edges):\n    t = time.time()\n    return edges\n",),
    },
    "autograd-function-paired": {
        "path": "dgraph_tpu_torch/ops/x.py",
        "bad": (
            "import torch\nclass Op(torch.autograd.Function):\n"
            "    @staticmethod\n    def forward(ctx, x):\n        return x\n"
        ),
        "good": (
            "import torch\nclass Op(torch.autograd.Function):\n"
            "    @staticmethod\n    def forward(ctx, x):\n        return x\n"
            "    @staticmethod\n    def backward(ctx, g):\n        return g\n"
        ),
        "more_bad": (),
    },
    "no-rank-branch-around-collective": {
        "path": "dgraph_tpu_torch/comm/x.py",
        "bad": (
            "import torch.distributed as dist\ndef sync(group, x):\n"
            "    if group.rank == 0:\n        dist.all_reduce(x, group=group.pg)\n"
        ),
        "good": (
            "import torch.distributed as dist\ndef sync(group, x):\n"
            "    if group.rank == 0:\n        x = x * 2\n"
            "    dist.all_reduce(x, group=group.pg)\n"
        ),
        "more_bad": (
            # the rank read through a local name, and an early exit
            "def put(group, x):\n    me = group.rank\n    if me != 0:\n        return x\n"
            "    group.barrier()\n",
            "import os\ndef step(group):\n    if int(os.environ['RANK']) > 0:\n"
            "        p2p_transport(group=group)\n",
        ),
    },
    "no-unpriced-wire-cast": {
        "path": "dgraph_tpu_torch/comm/x.py",
        "bad": (
            "import torch\nimport torch.distributed as dist\ndef send(x, group):\n"
            "    y = x.to(torch.bfloat16)\n    dist.all_reduce(y, group=group.pg)\n"
        ),
        "good": (
            "import torch\nimport torch.distributed as dist\ndef send(x, group, like):\n"
            "    y = x.to(like.dtype).to(torch.float32)\n    dist.all_reduce(y, group=group.pg)\n"
        ),
        "more_bad": (
            "def put(blocks, group):\n    return p2p_transport(blocks.half(), group=group)\n",
            "import torch\nimport torch.distributed as dist\ndef post(x, peer):\n"
            "    return dist.isend(x.to(dtype=torch.float8_e4m3fn).view(torch.uint8), peer)\n",
            "def put(blocks, group):\n    return p2p_transport(blocks.bfloat16(), group=group)\n",
        ),
    },
}


def lint_selftest_failures() -> list:
    """Every rule must fire on each of its bad fixtures and stay quiet on
    its good one; the pragma suppresses a finding."""
    failures = []
    for name, fx in FIXTURES.items():
        r = RULES[name]
        for src in (fx["bad"], *fx["more_bad"]):
            if not r.check(fx["path"], ast.parse(src), src.splitlines()):
                failures.append(f"rule {name!r} missed a fixture: {src!r}")
        got = r.check(fx["path"], ast.parse(fx["good"]), fx["good"].splitlines())
        if got:
            failures.append(f"rule {name!r} false-positived on clean code: {got}")
    src = "def poison(tree):\n    import jax  # lint: allow(no-jax-import)\n"
    got = [f for f in RULES["no-jax-import"].check("dgraph_tpu_torch/x.py", ast.parse(src),
                                                    src.splitlines())
           if not _suppressed(src.splitlines(), f.line, f.rule)]
    if got:
        failures.append("the pragma did not suppress a finding")
    return failures


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def repo_root() -> str:
    """The directory containing the ``dgraph_tpu_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def iter_source_files(root: str):
    """The port's Python files (its build directory and caches aside) and
    the root's scripts of :data:`SCRIPTS`."""
    pkg = os.path.join(root, PORT.rstrip("/"))
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "_build"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    for script in SCRIPTS:
        path = os.path.join(root, script)
        if os.path.isfile(path):
            yield path


def lint_file(path: str, root: str, rules=None) -> list:
    """Run every applicable rule over one file; returns unsuppressed
    findings."""
    relpath = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path) as f:
        source = f.read()
    lines = source.splitlines()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("syntax", relpath, e.lineno or 0, f"unparseable: {e}")]
    findings = []
    for r in (rules or RULES).values():
        if r.applies(relpath):
            findings.extend(f for f in r.check(relpath, tree, lines)
                            if not _suppressed(lines, f.line, f.rule))
    return findings


def run_lint(root: Optional[str] = None, rules=None) -> dict:
    """Lint the port and its scripts; returns a JSON-able report."""
    root = root or repo_root()
    findings, n_files = [], 0
    for path in iter_source_files(root):
        n_files += 1
        findings.extend(lint_file(path, root, rules))
    findings.sort(key=lambda f: (f.path, f.line))
    per_rule: dict = {}
    for f in findings:
        per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
    return {
        "kind": "lint_report",
        "root": root,
        "files_checked": n_files,
        "rules": sorted(RULES),
        "findings": [f.to_dict() for f in findings],
        "per_rule": per_rule,
        "ok": not findings,
    }
