"""Host-side concurrency & durability auditor: race / deadlock / torn-write
rules over the port's threaded host code — counterpart of
``dgraph_tpu/analysis/host/``.

The device-side verifier (:mod:`~dgraph_tpu_torch.analysis.kernel`) checks
the halo transport's put protocol; crash safety and liveness also hinge on
the host code that threads and locks: the serve engine (an ``RLock``), the
micro-batcher (a ``Condition`` and its worker thread), the metrics
registry, the kernel build module's library cache and the rank launcher. Every
rule below is *static* — the lock that guards a field, the acquisition
order of two locks, the statement that flips a generation pointer are all
visible in the AST — so the tier is pure-stdlib ``ast`` analysis and runs
with no card and no process group.

Rule families (all registered in
:data:`dgraph_tpu_torch.analysis.lint.RULES`, so ``--list_rules`` and the
``# lint: allow(<rule>)`` pragma work unchanged), the reference's five:

- ``host-lock-discipline`` — per class, infer the *guarded-field set*
  (attributes ever written inside a ``with self._lock`` /
  ``with self._cv`` block, where the lock attribute was assigned a
  ``threading.Lock/RLock/Condition``; container mutations like
  ``self._q.append`` count as writes) and flag any read or write of a
  guarded field outside that lock — including from nested functions
  handed to ``threading.Thread`` and daemon loops (entering a nested
  function RESETS the held-lock context).  Private helpers whose every
  in-class call site holds the lock are treated as lock-held;
  ``__init__`` is exempt (the object is not shared yet).
- ``host-lock-order`` — the lock-acquisition-order graph (lock held ->
  lock acquired, following direct calls transitively) over every module
  of :data:`HOST_SCOPE` at once must be acyclic: an inverted order
  *deadlocks*, it never errors.
- ``host-durable-write`` — every write destined for a durable artifact
  (generation pointers, manifests, ledgers, a checkpoint step's files)
  must flow through an atomic fsync+rename writer (or, for a checkpoint
  step, a synced writer into the temporary directory renamed into place);
  a bare ``open(path, "w")``, ``np.savez`` or ``torch.save`` onto such a
  path is RED.
- ``host-pointer-flip-last`` — in a function that writes a generation
  pointer, the pointer write is the LAST filesystem effect on every
  intra-procedural path to the exit.
- ``host-chaos-coverage`` — bidirectional drift check between a chaos
  registry's ``KNOWN_POINTS`` and the tree's ``chaos.fire("<point>")``
  call sites.  The port has no chaos registry yet (the resilience slice):
  the check runs over an empty registry and reports no points.

``python -m dgraph_tpu_torch.analysis.host`` audits the tree (nonzero exit
on any finding); ``--selftest`` runs the per-rule fixture pairs plus the
vacuity mutants (unlocked guarded-field write, seeded lock-order cycle,
bare-open manifest write, pointer-flip-before-payload, unregistered chaos
fire site — each must go RED), structural pins on the port's real locks,
then the clean-tree audit.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Optional

from dgraph_tpu_torch.analysis.lint import (
    Finding,
    _dotted,
    _last_segment,
    iter_source_files,
    lint_file,
    path_matcher,
    repo_root,
    rule,
)

__all__ = [
    "HOST_SCOPE",
    "scan_module",
    "class_concurrency_findings",
    "build_lock_graph",
    "lock_order_findings",
    "durable_write_findings",
    "pointer_flip_findings",
    "chaos_coverage_findings",
    "run_host_audit",
    "host_selftest_failures",
]

# the port's host modules (repo-relative posix prefixes): the serve
# engine's RLock, the batcher's Condition and worker thread, the model
# registry's lock, the rollover's swap under the dispatch lock, the graph
# deltas' run lock and generation pointer, the metrics registry, the kernel
# build module's library cache, the launcher, and the plan cache's artifact
# IO (shards, manifest, layout sidecar)
HOST_SCOPE = (
    "dgraph_tpu_torch/serve/engine.py",
    "dgraph_tpu_torch/serve/batcher.py",
    "dgraph_tpu_torch/serve/registry.py",
    "dgraph_tpu_torch/serve/rollover.py",
    "dgraph_tpu_torch/serve/deltas.py",
    "dgraph_tpu_torch/obs/metrics.py",
    "dgraph_tpu_torch/ops/_build.py",
    "dgraph_tpu_torch/comm/dist.py",
    "dgraph_tpu_torch/plan_shards.py",
)

# the durable-write rules cover the same modules (the graph deltas'
# generation pointer and snapshots among them) and the checkpoint and plan
# cache writer (the port writes no tuning record yet)
DURABLE_SCOPE = HOST_SCOPE + ("dgraph_tpu_torch/train/checkpoint.py",)

LOCK_CONSTRUCTORS = frozenset({"Lock", "RLock", "Condition"})

# method calls that mutate a container in place — a `self._q.append(x)`
# is a WRITE to `_q` for guarded-field inference
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "clear", "discard", "extend", "insert",
    "pop", "popleft", "popitem", "remove", "setdefault", "sort", "update",
})

# attribute-call names too generic to resolve across classes for the
# lock graph (file handles, futures, dict/list methods, lock protocol)
ATTR_RESOLUTION_BLOCKLIST = frozenset({
    "write", "read", "close", "flush", "open", "get", "set", "put", "pop",
    "append", "add", "update", "join", "start", "stop", "wait", "notify",
    "notify_all", "acquire", "release", "end", "items", "keys", "values",
    "copy", "clear", "result", "cancel", "save", "load", "run", "format",
    "strip", "split", "sleep",
})

# blessed durable writers (tmp + flush + fsync + os.replace inside; the
# ledger's append variant flush+fsyncs the appended line instead — its
# reader skips a torn trailing line with a reason, so append is durable)
ATOMIC_WRITERS = frozenset({
    "atomic_write_json", "atomic_pickle_dump", "atomic_savez",
    "atomic_append_jsonl",
})

# path-returning helpers whose results name durable artifacts
DURABLE_PATH_FNS = frozenset({
    "world_path", "graph_path", "manifest_path", "record_path",
    "ledger_path", "step_path",
})
# file names of durable artifacts; a module-level constant holding one
# (the checkpoint's STATE_FILE / KEYS_FILE) is durable in every function
DURABLE_NAME_HINTS = ("world.json", "serving.json", "manifest.json",
                      "ledger.jsonl", "state.pt", "keys.json")

# calls that touch the filesystem, for the pointer-flip-last walk
FS_EFFECT_CALLS = frozenset({
    "replace", "rename", "link", "unlink", "remove", "rmdir", "makedirs",
    "mkdir", "savez", "savez_compressed", "dump", "write_manifest",
    "save_checkpoint", "build_plan_shards", "write_world",
}) | ATOMIC_WRITERS

POINTER_WRITE_CALLS = frozenset({"write_world"})

# where a chaos registry lives (the resilience slice brings it)
CHAOS_DIR = "dgraph_tpu_torch/chaos/"
CHAOS_REGISTRY = CHAOS_DIR + "__init__.py"


def _self_attr(node) -> Optional[str]:
    """Attribute name when ``node`` is ``self.<attr>``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _self_root_attr(node) -> Optional[str]:
    """The first attribute above ``self`` in a chain like
    ``self._q.append`` or ``self._entries[name]`` — the field a mutator
    call / subscript store actually mutates."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        inner = node.value
        got = _self_attr(inner)
        if got is not None:
            return got
        node = inner
    return None


def _is_lock_ctor(value) -> bool:
    if not isinstance(value, ast.Call):
        return False
    if _last_segment(value.func) not in LOCK_CONSTRUCTORS:
        return False
    dotted = _dotted(value.func)
    return dotted.startswith("threading.") or "." not in dotted


# ---------------------------------------------------------------------------
# the module scanner (shared by lock-discipline and lock-order)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FnScan:
    """Concurrency-relevant facts about one function/method body."""

    relpath: str
    cls: Optional[str]
    name: str
    line: int
    # [(lock_id, line, held_before: tuple)] for every `with <lock>` entry
    acquires: list = dataclasses.field(default_factory=list)
    # [(held: tuple, kind, target, line)] for every call; kind is
    # "self" | "bare" | "attr"
    calls: list = dataclasses.field(default_factory=list)
    # [(field, "read"|"write", line, held_attrs: tuple)] self-attr access
    accesses: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClassScan:
    name: str
    lock_attrs: frozenset
    methods: dict  # name -> FnScan


@dataclasses.dataclass
class ModuleScan:
    relpath: str
    module_locks: dict  # name -> line, for NAME = threading.Lock() at top
    classes: dict       # name -> ClassScan
    functions: dict     # name -> FnScan (module level)


def _class_lock_attrs(cls_node: ast.ClassDef) -> frozenset:
    attrs = set()
    for node in ast.walk(cls_node):
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for t in node.targets:
                a = _self_attr(t)
                if a:
                    attrs.add(a)
    return frozenset(attrs)


def _lock_id_of(expr, relpath, cls_name, lock_attrs, module_locks):
    """The lock identity a ``with`` context expression acquires, or None
    when it is not a lock (``with open(...)``, ``with spans.span(...)``)."""
    attr = _self_attr(expr)
    if attr is not None and attr in lock_attrs:
        return ("class", relpath, cls_name, attr)
    if isinstance(expr, ast.Name) and expr.id in module_locks:
        return ("module", relpath, expr.id)
    if isinstance(expr, ast.Call):
        fname = _last_segment(expr.func)
        if "lock" in fname.lower():
            return ("factory", relpath, fname)
    return None


def _scan_fn(
    fn_node, relpath, cls_name, lock_attrs, module_locks
) -> FnScan:
    scan = FnScan(relpath, cls_name, fn_node.name, fn_node.lineno)

    def held_attrs(held) -> tuple:
        return tuple(
            lid[3] for lid in held if lid[0] == "class" and lid[2] == cls_name
        )

    def visit(node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # thread escape: a nested function's execution time is
            # unknown (Thread targets, callbacks) — an enclosing `with`
            # proves nothing about when its body runs
            body = node.body if not isinstance(node, ast.Lambda) else [
                ast.Expr(node.body)
            ]
            for child in body:
                visit(child, ())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            newly = []
            for item in node.items:
                visit(item.context_expr, held)
                lid = _lock_id_of(
                    item.context_expr, relpath, cls_name, lock_attrs,
                    module_locks,
                )
                if lid is not None:
                    scan.acquires.append((lid, node.lineno, tuple(held)))
                    newly.append(lid)
            inner = tuple(held) + tuple(newly)
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, ast.Call):
            fname = _last_segment(node.func)
            if isinstance(node.func, ast.Attribute):
                # `self.m()` is a same-class method call; `self.field.m()`
                # is a call INTO the object held in `field` (attr kind)
                if (
                    isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                ):
                    kind = "self"
                else:
                    kind = "attr"
                target = node.func.attr
                # container mutation on a self field is a write
                if node.func.attr in MUTATOR_METHODS:
                    root = _self_root_attr(node.func)
                    if root is not None and root not in lock_attrs:
                        scan.accesses.append(
                            (root, "write", node.lineno, held_attrs(held))
                        )
            elif isinstance(node.func, ast.Name):
                kind, target = "bare", node.func.id
            else:
                kind, target = "attr", fname
            if target:
                scan.calls.append((tuple(held), kind, target, node.lineno))
            for child in ast.iter_child_nodes(node):
                visit(child, held)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                targets = t.elts if isinstance(t, ast.Tuple) else [t]
                for tt in targets:
                    if isinstance(tt, ast.Subscript):
                        root = _self_root_attr(tt)
                        if root is not None and root not in lock_attrs:
                            scan.accesses.append(
                                (root, "write", node.lineno,
                                 held_attrs(held))
                            )
        if isinstance(node, ast.AugAssign):
            a = _self_attr(node.target)
            if a is not None and a not in lock_attrs:
                scan.accesses.append(
                    (a, "write", node.lineno, held_attrs(held))
                )
        if isinstance(node, ast.Attribute):
            a = _self_attr(node)
            if a is not None and a not in lock_attrs:
                kind = (
                    "write"
                    if isinstance(node.ctx, (ast.Store, ast.Del))
                    else "read"
                )
                scan.accesses.append((a, kind, node.lineno,
                                      held_attrs(held)))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fn_node.body:
        visit(stmt, ())
    return scan


def scan_module(relpath: str, tree: ast.AST) -> ModuleScan:
    """Full concurrency scan of one module: module-level locks, classes
    with their lock attributes and per-method :class:`FnScan`, and
    module-level functions."""
    module_locks = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    module_locks[t.id] = node.lineno
    classes, functions = {}, {}
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.ClassDef):
            lock_attrs = _class_lock_attrs(node)
            methods = {
                m.name: _scan_fn(m, relpath, node.name, lock_attrs,
                                 module_locks)
                for m in node.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            classes[node.name] = ClassScan(node.name, lock_attrs, methods)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions[node.name] = _scan_fn(
                node, relpath, None, frozenset(), module_locks
            )
    return ModuleScan(relpath, module_locks, classes, functions)


# ---------------------------------------------------------------------------
# rule 1: host-lock-discipline
# ---------------------------------------------------------------------------


def _held_extras(cs: ClassScan) -> tuple:
    """``(blessed, evidence)`` per method, for private helpers only (a
    public method can be entered from outside the class, where no call
    site is visible to this analysis):

    - ``blessed[m]`` — lock attrs EVERY in-class ``self.m()`` call site
      holds (intersection; fixpoint through calling helpers).  A body
      may *assume* these held, so its accesses are safe.
    - ``evidence[m]`` — lock attrs held at ANY in-class call site
      (union).  A write in ``m`` under such evidence marks the field
      lock-guarded for inference — so a helper called both with and
      without the lock still declares the contract its locked callers
      imply, and its own unlocked call sites then go RED.
    """
    blessed = {m: frozenset() for m in cs.methods}
    evidence = {m: frozenset() for m in cs.methods}
    sites: dict = {m: [] for m in cs.methods}
    for caller, scan in cs.methods.items():
        for held, kind, target, _line in scan.calls:
            if kind == "self" and target in cs.methods:
                sites[target].append((caller, held))

    # calls carry full held lock-id tuples; reduce to this class's attrs
    def attrs_of(held):
        return frozenset(
            lid[3] for lid in held
            if lid[0] == "class" and lid[2] == cs.name
        )

    for _ in range(len(cs.methods) + 1):
        changed = False
        for m, callers in sites.items():
            if not callers or not m.startswith("_") or m.startswith("__"):
                continue
            agreed, seen = None, frozenset()
            for caller, held in callers:
                eff = attrs_of(held) | blessed.get(caller, frozenset())
                agreed = eff if agreed is None else (agreed & eff)
                seen |= eff | evidence.get(caller, frozenset())
            agreed = agreed or frozenset()
            if agreed != blessed[m] or seen != evidence[m]:
                blessed[m], evidence[m] = agreed, seen
                changed = True
        if not changed:
            break
    return blessed, evidence


def class_concurrency_findings(relpath: str, tree: ast.AST,
                               lines: Optional[list] = None) -> list:
    """host-lock-discipline over one module: guarded-field inference +
    out-of-lock access flagging, per class."""
    ms = scan_module(relpath, tree)
    findings = []
    for cs in ms.classes.values():
        if not cs.lock_attrs:
            continue
        blessed, evidence = _held_extras(cs)
        # guarded inference: fields written with a class lock held —
        # lexically, or inside a private helper at least one of whose
        # call sites holds the lock (the contract its callers imply)
        guarded: dict = {}
        write_line: dict = {}
        for mname, scan in cs.methods.items():
            if mname == "__init__":
                continue
            infer_extra = evidence.get(mname, frozenset())
            for field, kind, line, held in scan.accesses:
                if kind != "write":
                    continue
                locks = frozenset(held) | infer_extra
                if locks:
                    guarded.setdefault(field, set()).update(locks)
                    write_line.setdefault(field, line)
        # flagging: any access to a guarded field without its lock held
        # FOR SURE (lexically, or blessed: every call site holds it)
        seen = set()
        for mname, scan in cs.methods.items():
            if mname == "__init__":
                continue
            eff_extra = blessed.get(mname, frozenset())
            for field, kind, line, held in scan.accesses:
                if field not in guarded:
                    continue
                if (frozenset(held) | eff_extra) & guarded[field]:
                    continue
                key = (field, line)
                if key in seen:
                    continue
                seen.add(key)
                locks = "/".join(sorted(guarded[field]))
                findings.append(Finding(
                    "host-lock-discipline", relpath, line,
                    f"{kind} of {cs.name}.{field} outside 'self.{locks}' "
                    f"(guarded: written under the lock at line "
                    f"{write_line[field]}); an unlocked {kind} races the "
                    f"locked writers — take the lock or snapshot under it",
                ))
    findings.sort(key=lambda f: f.line)
    return findings


@rule(
    "host-lock-discipline",
    "per class, any attribute ever written under a 'with self.<lock>' "
    "block (threading.Lock/RLock/Condition) is lock-guarded; every other "
    "read/write of it must hold the same lock — including from "
    "threading.Thread targets and daemon loops (nested functions reset "
    "the held-lock context). __init__ is exempt; private helpers whose "
    "every in-class call site holds the lock count as lock-held",
    path_matcher(*HOST_SCOPE),
    scope="serve/engine.py, serve/batcher.py, obs/metrics.py, ops/_build.py, "
          "comm/dist.py",
)
def check_host_lock_discipline(relpath: str, tree: ast.AST, lines: list):
    return class_concurrency_findings(relpath, tree, lines)


# ---------------------------------------------------------------------------
# rule 2: host-lock-order (repo-level)
# ---------------------------------------------------------------------------


def _render_lock(lid: tuple) -> str:
    if lid[0] == "class":
        return f"{lid[1]}::{lid[2]}.{lid[3]}"
    if lid[0] == "module":
        return f"{lid[1]}::{lid[2]}"
    return f"{lid[1]}::{lid[2]}()"


def build_lock_graph(modules: dict) -> dict:
    """The lock-acquisition-order graph over ``{relpath: ast}``.

    Returns ``{"edges": {(src, dst): (relpath, line)}, "locks": [...]}``
    where an edge src -> dst means "src held while dst is acquired",
    following direct calls transitively (``self.m`` -> same class, bare
    names -> same module, unambiguous attribute calls -> the one scanned
    function/method of that name)."""
    scans = {rp: scan_module(rp, tree) for rp, tree in modules.items()}
    # global indices for call resolution
    by_name: dict = {}
    for ms in scans.values():
        for fs in ms.functions.values():
            by_name.setdefault(fs.name, []).append(fs)
        for cs in ms.classes.values():
            for fs in cs.methods.values():
                by_name.setdefault(fs.name, []).append(fs)

    def resolve(fs: FnScan, kind: str, target: str) -> Optional[FnScan]:
        ms = scans[fs.relpath]
        if kind == "self" and fs.cls:
            return ms.classes[fs.cls].methods.get(target)
        if kind == "bare":
            return ms.functions.get(target)
        if target in ATTR_RESOLUTION_BLOCKLIST:
            return None
        cands = by_name.get(target, [])
        return cands[0] if len(cands) == 1 else None

    memo: dict = {}

    def locks_tx(fs: FnScan, stack: tuple) -> frozenset:
        key = (fs.relpath, fs.cls, fs.name)
        if key in memo:
            return memo[key]
        if key in stack:
            return frozenset()
        out = {lid for lid, _l, _h in fs.acquires}
        for _held, kind, target, _line in fs.calls:
            callee = resolve(fs, kind, target)
            if callee is not None:
                out |= locks_tx(callee, stack + (key,))
        memo[key] = frozenset(out)
        return memo[key]

    edges: dict = {}
    all_scans = [
        fs
        for ms in scans.values()
        for fs in list(ms.functions.values())
        + [m for cs in ms.classes.values() for m in cs.methods.values()]
    ]
    for fs in all_scans:
        for lid, line, held_before in fs.acquires:
            for h in held_before:
                if h != lid:
                    edges.setdefault((h, lid), (fs.relpath, line))
        for held, kind, target, line in fs.calls:
            if not held:
                continue
            callee = resolve(fs, kind, target)
            if callee is None:
                continue
            for m in locks_tx(callee, ()):
                for h in held:
                    if h != m:
                        edges.setdefault((h, m), (fs.relpath, line))
    locks = sorted({lid for e in edges for lid in e})
    # the per-module scans ride along so callers (run_host_audit's
    # guarded-class summary) never re-parse or re-scan the same sources
    return {"edges": edges, "locks": locks, "scans": scans}


def _find_cycles(edges: dict) -> list:
    """One representative cycle per strongly connected component of the
    edge set (Tarjan).  SCC-based on purpose: ANY cycle — any length,
    any node ordering — makes its SCC non-trivial, so no deadlockable
    order can hide (a path-enumeration shortcut here once missed
    non-monotone 3-cycles; pinned by the selftest's bad3 fixture)."""
    adj: dict = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
    nodes = sorted({n for e in edges for n in e})
    index: dict = {}
    low: dict = {}
    onstack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]

    def strong(v):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        onstack.add(v)
        for w in sorted(adj.get(v, ())):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in onstack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                onstack.discard(w)
                comp.append(w)
                if w == v:
                    break
            sccs.append(comp)

    for n in nodes:
        if n not in index:
            strong(n)

    cycles = []
    for comp in sccs:
        compset = set(comp)
        if len(comp) == 1 and comp[0] not in adj.get(comp[0], ()):
            continue  # trivial SCC, no self-loop
        # walk one concrete cycle inside the SCC (every edge followed is
        # a real edge, so the finding's step list renders verbatim)
        start = min(comp)
        path = [start]
        seen = {start}

        def walk(v):
            for w in sorted(adj.get(v, ())):
                if w == start:
                    return True
                if w in compset and w not in seen:
                    seen.add(w)
                    path.append(w)
                    if walk(w):
                        return True
                    path.pop()
                    seen.discard(w)
            return False

        walk(start)
        cycles.append(path + [start])
    return cycles


def lock_order_findings(modules: dict, graph: Optional[dict] = None) -> list:
    graph = graph if graph is not None else build_lock_graph(modules)
    findings = []
    for cyc in _find_cycles(graph["edges"]):
        steps = []
        for a, b in zip(cyc, cyc[1:]):
            rp, line = graph["edges"][(a, b)]
            steps.append(f"{_render_lock(a)} -> {_render_lock(b)} "
                         f"({rp}:{line})")
        rp0, line0 = graph["edges"][(cyc[0], cyc[1])]
        findings.append(Finding(
            "host-lock-order", rp0, line0,
            "lock-acquisition-order cycle (a schedule exists that "
            "deadlocks, and deadlocks hang rather than error): "
            + "; ".join(steps),
        ))
    return findings


def _host_scope_modules(root: str) -> dict:
    out = {}
    for path in iter_source_files(root):
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        if any(relpath.startswith(p) for p in HOST_SCOPE):
            try:
                out[relpath] = ast.parse(open(path).read())
            except (OSError, SyntaxError):
                continue
    return out


@rule(
    "host-lock-order",
    "the control-plane lock-acquisition-order graph (lock held -> lock "
    "acquired, following direct calls, module-level locks included) "
    "must be acyclic: an inverted order deadlocks "
    "— it never errors — on the first unlucky schedule",
    lambda relpath: False,  # repo-level: runs via run_host_audit
    scope="repo-level over the host control-plane modules "
          "(run_host_audit / python -m dgraph_tpu_torch.analysis.host)",
)
def check_host_lock_order(relpath: str, tree: ast.AST, lines: list,
                          root: str = ""):
    if not root:
        return []
    return lock_order_findings(_host_scope_modules(root))


# ---------------------------------------------------------------------------
# rule 3: host-durable-write
# ---------------------------------------------------------------------------


def _expr_durable(expr, tainted: set) -> Optional[str]:
    """Why ``expr`` names a durable artifact path (helper call, durable
    constant, or tainted name), or None."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            fname = _last_segment(node.func)
            if fname in DURABLE_PATH_FNS:
                return f"{fname}(...)"
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for hint in DURABLE_NAME_HINTS:
                if hint in node.value:
                    return f"{node.value!r}"
        if isinstance(node, ast.Name) and node.id in tainted:
            return f"name {node.id!r} (durable-path dataflow)"
    return None


def _open_write_mode(call: ast.Call) -> bool:
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return isinstance(mode, str) and any(c in mode for c in "wax")


def durable_write_findings(relpath: str, tree: ast.AST, lines: list) -> list:
    findings = []
    module_names = {
        t.id
        for node in getattr(tree, "body", [])
        if isinstance(node, ast.Assign) and _expr_durable(node.value, set())
        for t in node.targets if isinstance(t, ast.Name)
    }
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if "atomic" in fn.name:
            continue  # the blessed writers' own tmp-file opens
        # local taint: names assigned from durable path expressions,
        # iterated to fixpoint (handles tmp = path + ".tmp")
        tainted: set = set(module_names)
        for _ in range(4):
            grew = False
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and _expr_durable(
                    node.value, tainted
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id not in tainted:
                            tainted.add(t.id)
                            grew = True
            if not grew:
                break
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            fname = _last_segment(node.func)
            why = None
            if fname == "open" and node.args and _open_write_mode(node):
                why = _expr_durable(node.args[0], tainted)
                verb = "bare open(..., 'w')"
            elif fname in ("savez", "savez_compressed") and node.args:
                why = _expr_durable(node.args[0], tainted)
                verb = f"direct np.{fname}"
            elif fname == "save" and len(node.args) >= 2:
                why = _expr_durable(node.args[1], tainted)
                verb = "direct torch.save"
            if why:
                findings.append(Finding(
                    "host-durable-write", relpath, node.lineno,
                    f"{verb} to a durable artifact path ({why}) in "
                    f"{fn.name!r}: route through atomic_write_json / "
                    f"atomic_pickle_dump / atomic_savez — without the "
                    f"fsync+rename discipline a host crash can commit "
                    f"the name before the bytes (torn artifact under a "
                    f"valid name)",
                ))
    findings.sort(key=lambda f: f.line)
    return findings


@rule(
    "host-durable-write",
    "writes to durable artifacts (world.json/serving.json pointers, "
    "graph_g<N>.npz snapshots, plan-shard manifests, tuning records, "
    "checkpoint step files) must flow through atomic_write_json/"
    "atomic_pickle_dump/atomic_savez or a synced writer — a bare "
    "open(path,'w'), direct np.savez or torch.save to such a path is a "
    "torn write waiting for a host crash",
    path_matcher(*DURABLE_SCOPE),
    scope="the host modules of HOST_SCOPE and the checkpoint writer "
          "(DURABLE_SCOPE)",
)
def check_host_durable_write(relpath: str, tree: ast.AST, lines: list):
    return durable_write_findings(relpath, tree, lines)


# ---------------------------------------------------------------------------
# rule 4: host-pointer-flip-last
# ---------------------------------------------------------------------------


def _is_pointer_write(call: ast.Call) -> bool:
    fname = _last_segment(call.func)
    if fname in POINTER_WRITE_CALLS:
        return True
    if fname in ("atomic_write_json", "atomic_savez") and call.args:
        for n in ast.walk(call.args[0]):
            if isinstance(n, ast.Call) and (
                _last_segment(n.func) == "world_path"
            ):
                return True
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and (
                "world.json" in n.value or "serving.json" in n.value
            ):
                return True
    return False


def _child_blocks(stmt):
    for field in ("body", "orelse", "finalbody"):
        block = getattr(stmt, field, None)
        if block:
            yield block
    for handler in getattr(stmt, "handlers", []):
        yield handler.body


def _chain_to_call(block, owner, call):
    """Path of (owner, block, idx) from ``block`` down to the innermost
    statement whose non-nested subtree contains ``call``."""
    for i, stmt in enumerate(block):
        if not any(n is call for n in ast.walk(stmt)):
            continue
        for child in _child_blocks(stmt):
            sub = _chain_to_call(child, stmt, call)
            if sub is not None:
                return [(owner, block, i)] + sub
        return [(owner, block, i)]
    return None


def _fs_effects_in(node) -> list:
    """(line, name) for filesystem-effect calls in ``node``, not
    descending into nested function definitions."""
    out = []
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)) and n is not node:
            continue
        if isinstance(n, ast.Call):
            fname = _last_segment(n.func)
            if fname in FS_EFFECT_CALLS:
                out.append((n.lineno, fname))
            elif fname == "open" and n.args and _open_write_mode(n):
                out.append((n.lineno, "open(w)"))
        stack.extend(ast.iter_child_nodes(n))
    return out


def _effects_after_flip(path) -> list:
    """Filesystem effects reachable AFTER the pointer flip on the
    intra-procedural CFG: remaining statements of each enclosing block,
    loop back edges (unless the path returns/raises/breaks first), and
    try/finally bodies."""
    bad = []
    pending_break = False
    for level in range(len(path) - 1, -1, -1):
        owner, block, idx = path[level]
        exited = False
        for stmt in block[idx + 1:]:
            bad.extend(_fs_effects_in(stmt))
            if isinstance(stmt, (ast.Return, ast.Raise)):
                exited = True
                break
            if isinstance(stmt, ast.Break):
                pending_break = True
                break
            if isinstance(stmt, ast.Continue):
                break
        if exited:
            # the function exits on this path — but every ENCLOSING
            # try/finally still runs its finalbody after the return
            # (a finally that writes after the flip is exactly the
            # hidden-effect shape; pinned by the selftest's bad_finally fixture)
            for o, _b, _i in path[: level + 1]:
                if isinstance(o, ast.Try):
                    for s in o.finalbody:
                        bad.extend(_fs_effects_in(s))
            return bad
        if isinstance(owner, (ast.For, ast.AsyncFor, ast.While)):
            if not pending_break:
                # back edge: the whole loop body may run again
                for s in owner.body:
                    bad.extend(_fs_effects_in(s))
            pending_break = False
        elif isinstance(owner, ast.Try):
            for s in owner.finalbody:
                bad.extend(_fs_effects_in(s))
    return bad


def pointer_flip_findings(relpath: str, tree: ast.AST, lines: list) -> list:
    findings = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        flips = [
            n for n in ast.walk(fn)
            if isinstance(n, ast.Call) and _is_pointer_write(n)
        ]
        for flip in flips:
            path = _chain_to_call(fn.body, fn, flip)
            if path is None:
                continue
            effects = _effects_after_flip(path)
            # the flip call itself re-found via a loop back edge is the
            # same single commit point, not a second effect
            effects = [e for e in effects if e[0] != flip.lineno]
            if effects:
                lst = ", ".join(f"{name}@{line}" for line, name in
                                sorted(set(effects))[:4])
                findings.append(Finding(
                    "host-pointer-flip-last", relpath, flip.lineno,
                    f"generation-pointer write in {fn.name!r} is not the "
                    f"last filesystem effect on some path to the exit "
                    f"({lst} can still run after the flip): a crash "
                    f"between the flip and the later write adopts a "
                    f"generation whose payload is not durable — the "
                    f"old-or-new-never-torn contract requires every "
                    f"artifact durable BEFORE the pointer moves",
                ))
    findings.sort(key=lambda f: f.line)
    return findings


@rule(
    "host-pointer-flip-last",
    "in a commit function, the generation-pointer write (write_world / "
    "atomic_write_json of a world_path) must be the LAST filesystem "
    "effect on every intra-procedural CFG path: payload durable before "
    "the pointer moves, or a crash adopts a torn generation",
    path_matcher(*HOST_SCOPE),
    scope="host control-plane modules (commit functions)",
)
def check_host_pointer_flip(relpath: str, tree: ast.AST, lines: list):
    return pointer_flip_findings(relpath, tree, lines)


# ---------------------------------------------------------------------------
# rule 5: host-chaos-coverage
# ---------------------------------------------------------------------------


def _known_points_from_tree(tree: ast.AST) -> dict:
    """``{point: line}`` parsed from a ``KNOWN_POINTS = {...}`` literal."""
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "KNOWN_POINTS"
            for t in node.targets
        ):
            if isinstance(node.value, ast.Dict):
                return {
                    k.value: k.lineno
                    for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                }
    return {}


def _fire_sites(modules: dict) -> list:
    """``(point, relpath, line)`` for every ``chaos.fire("<point>")``
    call with a string-literal point across ``{relpath: tree}``."""
    sites = []
    for relpath, tree in modules.items():
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and _last_segment(node.func) == "fire"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                sites.append((node.args[0].value, relpath, node.lineno))
    return sites


def chaos_coverage_findings(
    root: Optional[str] = None,
    *,
    points: Optional[dict] = None,
    modules: Optional[dict] = None,
) -> list:
    """Bidirectional KNOWN_POINTS <-> fire-site drift check.  With
    ``root`` given, both sides come from the tree; tests pass explicit
    ``points`` (``{name: line}``) and ``modules`` (``{relpath: ast}``)."""
    if points is None or modules is None:
        root = root or repo_root()
        chaos_path = os.path.join(root, *CHAOS_REGISTRY.split("/"))
        parsed_points = _known_points_from_tree(ast.parse(
            open(chaos_path).read() if os.path.isfile(chaos_path) else ""
        ))
        all_modules = {}
        for path in iter_source_files(root):
            relpath = os.path.relpath(path, root).replace(os.sep, "/")
            try:
                all_modules[relpath] = ast.parse(open(path).read())
            except (OSError, SyntaxError):
                continue
        points = parsed_points if points is None else points
        modules = all_modules if modules is None else modules
    sites = _fire_sites(modules)
    findings = []
    fired = {}
    for point, relpath, line in sites:
        fired.setdefault(point, []).append((relpath, line))
        if point not in points:
            findings.append(Finding(
                "host-chaos-coverage", relpath, line,
                f"chaos.fire({point!r}) names a point KNOWN_POINTS does "
                f"not register: the clause grammar rejects it at arm "
                f"time, so this site is permanently inert — register "
                f"the point or fix the name",
            ))
    for point, line in sorted(points.items()):
        real = [
            (rp, ln) for rp, ln in fired.get(point, [])
            if not rp.startswith(CHAOS_DIR)
        ]
        if not real:
            findings.append(Finding(
                "host-chaos-coverage", CHAOS_REGISTRY,
                line,
                f"KNOWN_POINTS entry {point!r} has no fire site outside "
                f"{CHAOS_DIR}: a clause naming it parses but "
                f"never fires — the registry documents a boundary that "
                f"does not exist",
            ))
    return findings


@rule(
    "host-chaos-coverage",
    "bidirectional chaos-registry drift check: every KNOWN_POINTS entry "
    "must have a chaos.fire site outside the chaos package, and every "
    "fire site must name a registered point (an unregistered site is "
    "permanently inert; an unfired point is documentation, not "
    "coverage)",
    lambda relpath: False,  # repo-level: runs via run_host_audit
    scope="repo-level: chaos/__init__.py KNOWN_POINTS (none yet) vs "
          "every fire site of the port",
)
def check_host_chaos_coverage(relpath: str, tree: ast.AST, lines: list,
                              root: str = ""):
    if not root:
        return []
    return chaos_coverage_findings(root)


HOST_FILE_RULES = (
    "host-lock-discipline", "host-durable-write", "host-pointer-flip-last",
)
HOST_REPO_RULES = ("host-lock-order", "host-chaos-coverage")
HOST_RULES = HOST_FILE_RULES + HOST_REPO_RULES


# ---------------------------------------------------------------------------
# the audit runner
# ---------------------------------------------------------------------------


def run_host_audit(root: Optional[str] = None,
                   file_rules: bool = True) -> dict:
    """Audit the tree: per-file host rules (pragma-aware, via the lint
    machinery) plus the repo-level lock-order and chaos-coverage checks.
    ``file_rules=False`` skips the per-file pass — the analysis CLI's
    default mode uses that, because its lint pass already ran them."""
    from dgraph_tpu_torch.analysis.lint import RULES

    root = root or repo_root()
    findings = []
    files_checked = 0
    # ONE parse of the tree feeds every repo-level check (chaos coverage
    # needs all modules; the lock graph the host-scope subset)
    all_modules: dict = {}
    for path in iter_source_files(root):
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            all_modules[relpath] = ast.parse(open(path).read())
        except (OSError, SyntaxError):
            continue
    if file_rules:
        rules = {name: RULES[name] for name in HOST_FILE_RULES}
        for path in iter_source_files(root):
            relpath = os.path.relpath(path, root).replace(os.sep, "/")
            if not any(relpath.startswith(p) for p in DURABLE_SCOPE):
                continue
            files_checked += 1
            findings.extend(lint_file(path, root, rules))
    modules = {
        rp: t for rp, t in all_modules.items()
        if any(rp.startswith(p) for p in HOST_SCOPE)
    }
    graph = build_lock_graph(modules)
    findings.extend(lock_order_findings(modules, graph))
    points = _known_points_from_tree(
        all_modules.get(CHAOS_REGISTRY, ast.parse(""))
    )
    findings.extend(
        chaos_coverage_findings(points=points, modules=all_modules)
    )
    findings.sort(key=lambda f: (f.path, f.line))
    per_rule: dict = {}
    for f in findings:
        per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
    # structural summary: guarded-field sets per class (the evidence the
    # race rule is not vacuously inferring nothing) + the lock graph —
    # reusing the scans the lock graph already computed
    classes = {}
    for relpath in sorted(modules):
        ms = graph["scans"][relpath]
        for cs in ms.classes.values():
            if not cs.lock_attrs:
                continue
            _blessed, evidence = _held_extras(cs)
            guarded = set()
            for mname, scan in cs.methods.items():
                if mname == "__init__":
                    continue
                for field, kind, _line, held in scan.accesses:
                    if kind == "write" and (
                        frozenset(held) | evidence.get(mname, frozenset())
                    ):
                        guarded.add(field)
            classes[f"{relpath}::{cs.name}"] = {
                "locks": sorted(cs.lock_attrs),
                "guarded_fields": sorted(guarded),
            }
    return {
        "kind": "host_audit",
        "root": root,
        "files_checked": files_checked,
        "rules": list(HOST_RULES),
        "findings": [f.to_dict() for f in findings],
        "per_rule": per_rule,
        "failures": [
            f"{f.rule} {f.path}:{f.line}: {f.message}" for f in findings
        ],
        "classes": classes,
        "lock_edges": sorted(
            f"{_render_lock(a)} -> {_render_lock(b)}"
            for (a, b) in graph["edges"]
        ),
        "chaos_points": len(points),
        "ok": not findings,
    }


# ---------------------------------------------------------------------------
# selftest: fixture pairs + vacuity mutants
# ---------------------------------------------------------------------------

# every bad fixture is a faithful miniature of a real shape the reference's
# first clean-tree run surfaced in dgraph_tpu/ (its fixes are pinned in
# tests/test_analysis_host.py) — they double as the vacuity mutants: a
# green clean-tree audit is only evidence while these stay RED.

_LOCK_FIXTURE = {
    "path": "dgraph_tpu_torch/serve/batcher.py",
    # the pre-fix MicroBatcher shape: _inflight written under the cv in
    # _collect, then reset WITHOUT it from the worker loop
    "bad": (
        "import threading\n"
        "class Batcher:\n"
        "    def __init__(self):\n"
        "        self._cv = threading.Condition()\n"
        "        self._inflight = []\n"
        "    def _collect(self):\n"
        "        with self._cv:\n"
        "            batch = self._inflight = []\n"
        "        return batch\n"
        "    def _loop(self):\n"
        "        while True:\n"
        "            self._collect()\n"
        "            self._inflight = []\n"
    ),
    "good": (
        "import threading\n"
        "class Batcher:\n"
        "    def __init__(self):\n"
        "        self._cv = threading.Condition()\n"
        "        self._inflight = []\n"
        "    def _collect(self):\n"
        "        with self._cv:\n"
        "            batch = self._inflight = []\n"
        "        return batch\n"
        "    def _loop(self):\n"
        "        while True:\n"
        "            self._collect()\n"
        "            with self._cv:\n"
        "                self._inflight = []\n"
    ),
}

# thread-escape: the enclosing `with` must NOT bless a nested Thread
# target's body
_THREAD_ESCAPE_BAD = (
    "import threading\n"
    "class Engine:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self.state = 0\n"
    "    def start(self):\n"
    "        with self._lock:\n"
    "            self.state = 1\n"
    "            def worker():\n"
    "                self.state = 2\n"
    "            threading.Thread(target=worker).start()\n"
)

_ORDER_FIXTURE = {
    # seeded two-lock cycle across two classes: A holds la and calls into
    # B (acquires lb); B holds lb and calls back into A (acquires la)
    "bad": {
        "a.py": (
            "import threading\n"
            "class A:\n"
            "    def __init__(self, b):\n"
            "        self._la = threading.Lock()\n"
            "        self.b = b\n"
            "    def f(self):\n"
            "        with self._la:\n"
            "            self.b.g_of_b()\n"
            "    def h_of_a(self):\n"
            "        with self._la:\n"
            "            pass\n"
        ),
        "b.py": (
            "import threading\n"
            "class B:\n"
            "    def __init__(self, a):\n"
            "        self._lb = threading.Lock()\n"
            "        self.a = a\n"
            "    def g_of_b(self):\n"
            "        with self._lb:\n"
            "            self.a.h_of_a()\n"
        ),
    },
    "good": {
        "a.py": (
            "import threading\n"
            "class A:\n"
            "    def __init__(self, b):\n"
            "        self._la = threading.Lock()\n"
            "        self.b = b\n"
            "    def f(self):\n"
            "        with self._la:\n"
            "            self.b.g_of_b()\n"
        ),
        "b.py": (
            "import threading\n"
            "class B:\n"
            "    def __init__(self):\n"
            "        self._lb = threading.Lock()\n"
            "    def g_of_b(self):\n"
            "        with self._lb:\n"
            "            pass\n"
        ),
    },
    # a three-lock cycle whose walk from its minimum lock is NOT
    # monotone in the lock ordering (la -> lc -> lb -> la): the class of
    # cycle a path-enumeration shortcut once missed — SCC detection must
    # keep finding it
    "bad3": {
        "m1.py": (
            "import threading\n"
            "class A:\n"
            "    def __init__(self, c):\n"
            "        self._la = threading.Lock()\n"
            "        self.c = c\n"
            "    def f_of_a(self):\n"
            "        with self._la:\n"
            "            self.c.g_of_c()\n"
            "    def t_of_a(self):\n"
            "        with self._la:\n"
            "            pass\n"
        ),
        "m2.py": (
            "import threading\n"
            "class C:\n"
            "    def __init__(self, b):\n"
            "        self._lc = threading.Lock()\n"
            "        self.b = b\n"
            "    def g_of_c(self):\n"
            "        with self._lc:\n"
            "            self.b.h_of_b()\n"
        ),
        "m3.py": (
            "import threading\n"
            "class B:\n"
            "    def __init__(self, a):\n"
            "        self._lb = threading.Lock()\n"
            "        self.a = a\n"
            "    def h_of_b(self):\n"
            "        with self._lb:\n"
            "            self.a.t_of_a()\n"
        ),
    },
}

_DURABLE_FIXTURE = {
    "path": "dgraph_tpu_torch/train/shrink.py",
    # the pre-fix shrink shape: np.savez straight onto graph_path, and a
    # bare open onto the manifest
    "bad": (
        "import numpy as np\n"
        "def snapshot(run_dir, gen, edges):\n"
        "    np.savez(graph_path(run_dir, gen), edge_index=edges)\n"
        "def tamper(plan_dir):\n"
        "    mpath = manifest_path(plan_dir)\n"
        "    open(mpath, 'w').write('{}')\n"
    ),
    "good": (
        "from dgraph_tpu_torch.plan_shards import atomic_savez, atomic_write_json\n"
        "def snapshot(run_dir, gen, edges):\n"
        "    atomic_savez(graph_path(run_dir, gen), edge_index=edges)\n"
        "def write(plan_dir, man):\n"
        "    atomic_write_json(manifest_path(plan_dir), man)\n"
    ),
}

_LEDGER_DURABLE_FIXTURE = {
    "path": "dgraph_tpu_torch/obs/ledger.py",
    # a bare append onto the ledger: a host crash mid-write tears the
    # line with nothing fsynced behind it
    "bad": (
        "import json\n"
        "def append(d, recs):\n"
        "    fh = open(ledger_path(d), 'a')\n"
        "    for r in recs:\n"
        "        fh.write(json.dumps(r) + '\\n')\n"
    ),
    # the blessed shape: the append writer flush+fsyncs before returning
    "good": (
        "def append(d, recs):\n"
        "    atomic_append_jsonl(ledger_path(d), recs)\n"
    ),
}

_CKPT_DURABLE_FIXTURE = {
    "path": "dgraph_tpu_torch/train/checkpoint.py",
    # the checkpoint's own shape with its discipline gone: torch.save and
    # a bare open straight into the step directory, no tmp dir, no fsync
    "bad": (
        "import os, torch\n"
        "STATE_FILE = 'state.pt'\n"
        "KEYS_FILE = 'keys.json'\n"
        "def save_checkpoint(ckpt_dir, state, step):\n"
        "    final = step_path(ckpt_dir, step)\n"
        "    os.makedirs(final, exist_ok=True)\n"
        "    torch.save(state, os.path.join(final, STATE_FILE))\n"
        "    open(os.path.join(final, KEYS_FILE), 'w').write('[]')\n"
    ),
    # the blessed shape: a synced writer into the tmp dir renamed into place
    "good": (
        "import os, torch\n"
        "STATE_FILE = 'state.pt'\n"
        "def save_checkpoint(ckpt_dir, state, step):\n"
        "    final = step_path(ckpt_dir, step)\n"
        "    tmp = final + '.tmp'\n"
        "    _write_synced(os.path.join(tmp, STATE_FILE), lambda f: torch.save(state, f))\n"
        "    os.replace(tmp, final)\n"
    ),
}

_FLIP_FIXTURE = {
    "path": "dgraph_tpu_torch/train/shrink.py",
    # pointer-flip-before-payload: the world pointer moves, THEN the
    # graph snapshot lands — a crash between the two adopts a torn world
    "bad": (
        "import numpy as np\n"
        "def commit(run_dir, rec, edges):\n"
        "    write_world(run_dir, rec)\n"
        "    np.savez(graph_path(run_dir, 1), edge_index=edges)\n"
    ),
    # the replan shape: flip-then-return inside a retry loop whose body
    # rebuilds artifacts — the back edge never follows the flip
    "good": (
        "def commit(run_dir, rec, build):\n"
        "    for _ in range(5):\n"
        "        build()\n"
        "        if ready(run_dir):\n"
        "            write_world(run_dir, rec)\n"
        "            return rec\n"
        "    raise RuntimeError('quiesce appends')\n"
    ),
    # a finally body runs AFTER the post-flip return — hidden payload
    # write the early-return walk once missed
    "bad_finally": (
        "import os\n"
        "def commit(run_dir, rec, tmp, path):\n"
        "    try:\n"
        "        write_world(run_dir, rec)\n"
        "        return rec\n"
        "    finally:\n"
        "        os.replace(tmp, path)\n"
    ),
}

_CHAOS_FIXTURE = {
    # unregistered fire site + uncovered registry point
    "points": {"ckpt.save": 10, "serve.ghost": 11},
    "bad_modules": {
        "dgraph_tpu_torch/train/checkpoint.py":
            "def save():\n    chaos.fire('ckpt.save')\n",
        "dgraph_tpu_torch/serve/engine.py":
            "def infer():\n    chaos.fire('serve.typo')\n",
    },
    "good_points": {"ckpt.save": 10},
    "good_modules": {
        "dgraph_tpu_torch/train/checkpoint.py":
            "def save():\n    chaos.fire('ckpt.save')\n",
    },
}


def host_selftest_failures(root: Optional[str] = None) -> list:
    """Every failure string the host tier's selftest produces: per-rule
    fixture pairs, the vacuity mutants (each must go RED), pragma
    support, real-tree structural pins, and the clean-tree audit."""
    from dgraph_tpu_torch.analysis.lint import RULES, _suppressed

    failures: list = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    def run_file_rule(name, path, src):
        tree = ast.parse(src)
        return RULES[name].check(path, tree, src.splitlines())

    # --- host-lock-discipline: fixture pair + thread escape ---
    got = run_file_rule("host-lock-discipline", _LOCK_FIXTURE["path"],
                        _LOCK_FIXTURE["bad"])
    check(got, "host-lock-discipline missed an unlocked guarded-field "
               "write (vacuity mutant stayed GREEN)")
    got = run_file_rule("host-lock-discipline", _LOCK_FIXTURE["path"],
                        _LOCK_FIXTURE["good"])
    check(not got, f"host-lock-discipline false-positived on locked "
                   f"code: {got}")
    got = run_file_rule("host-lock-discipline", "dgraph_tpu_torch/serve/x.py",
                        _THREAD_ESCAPE_BAD)
    check(got, "host-lock-discipline treated a nested Thread target as "
               "covered by the enclosing with-lock (thread escape)")

    # --- host-lock-order: seeded cycle RED, acyclic GREEN ---
    bad = {p: ast.parse(s) for p, s in _ORDER_FIXTURE["bad"].items()}
    got = lock_order_findings(bad)
    check(got, "host-lock-order missed a seeded two-lock cycle "
               "(vacuity mutant stayed GREEN)")
    good = {p: ast.parse(s) for p, s in _ORDER_FIXTURE["good"].items()}
    got = lock_order_findings(good)
    check(not got, f"host-lock-order false-positived on an acyclic "
                   f"graph: {got}")
    bad3 = {p: ast.parse(s) for p, s in _ORDER_FIXTURE["bad3"].items()}
    got = lock_order_findings(bad3)
    check(got, "host-lock-order missed a non-monotone three-lock cycle "
               "(the SCC detector regressed to path enumeration)")

    # --- host-durable-write ---
    got = run_file_rule("host-durable-write", _DURABLE_FIXTURE["path"],
                        _DURABLE_FIXTURE["bad"])
    check(len(got) >= 2, "host-durable-write missed a bare "
                         "open/np.savez onto a durable path (vacuity "
                         "mutant stayed GREEN)")
    got = run_file_rule("host-durable-write", _DURABLE_FIXTURE["path"],
                        _DURABLE_FIXTURE["good"])
    check(not got, f"host-durable-write false-positived on the atomic "
                   f"writers: {got}")
    got = run_file_rule("host-durable-write",
                        _LEDGER_DURABLE_FIXTURE["path"],
                        _LEDGER_DURABLE_FIXTURE["bad"])
    check(got, "host-durable-write missed a bare open(ledger_path, 'a') "
               "(ledger-append vacuity mutant stayed GREEN)")
    got = run_file_rule("host-durable-write",
                        _LEDGER_DURABLE_FIXTURE["path"],
                        _LEDGER_DURABLE_FIXTURE["good"])
    check(not got, f"host-durable-write false-positived on "
                   f"atomic_append_jsonl: {got}")
    got = run_file_rule("host-durable-write", _CKPT_DURABLE_FIXTURE["path"],
                        _CKPT_DURABLE_FIXTURE["bad"])
    check(len(got) >= 2, "host-durable-write missed a torch.save / bare "
                         "open straight into a checkpoint step (vacuity "
                         "mutant stayed GREEN)")
    got = run_file_rule("host-durable-write", _CKPT_DURABLE_FIXTURE["path"],
                        _CKPT_DURABLE_FIXTURE["good"])
    check(not got, f"host-durable-write false-positived on the "
                   f"checkpoint's synced tmp-dir write: {got}")

    # --- host-pointer-flip-last ---
    got = run_file_rule("host-pointer-flip-last", _FLIP_FIXTURE["path"],
                        _FLIP_FIXTURE["bad"])
    check(got, "host-pointer-flip-last missed a flip-before-payload "
               "(vacuity mutant stayed GREEN)")
    got = run_file_rule("host-pointer-flip-last", _FLIP_FIXTURE["path"],
                        _FLIP_FIXTURE["good"])
    check(not got, f"host-pointer-flip-last false-positived on the "
                   f"flip-then-return retry loop: {got}")
    got = run_file_rule("host-pointer-flip-last", _FLIP_FIXTURE["path"],
                        _FLIP_FIXTURE["bad_finally"])
    check(got, "host-pointer-flip-last missed a try/finally payload "
               "write running after the post-flip return")

    # --- host-chaos-coverage ---
    got = chaos_coverage_findings(
        points=_CHAOS_FIXTURE["points"],
        modules={p: ast.parse(s)
                 for p, s in _CHAOS_FIXTURE["bad_modules"].items()},
    )
    check(
        any("serve.typo" in f.message for f in got),
        "host-chaos-coverage missed an unregistered fire site (vacuity "
        "mutant stayed GREEN)",
    )
    check(
        any("serve.ghost" in f.message for f in got),
        "host-chaos-coverage missed a registered point with no fire site",
    )
    got = chaos_coverage_findings(
        points=_CHAOS_FIXTURE["good_points"],
        modules={p: ast.parse(s)
                 for p, s in _CHAOS_FIXTURE["good_modules"].items()},
    )
    check(not got, f"host-chaos-coverage false-positived on a matched "
                   f"registry: {got}")

    # --- pragma shares lint's plumbing ---
    src = _LOCK_FIXTURE["bad"].replace(
        "            self._inflight = []\n",
        "            self._inflight = []"
        "  # lint: allow(host-lock-discipline)\n",
    )
    got = run_file_rule("host-lock-discipline", _LOCK_FIXTURE["path"], src)
    got = [f for f in got
           if not _suppressed(src.splitlines(), f.line, f.rule)]
    check(not got, "the lint pragma did not suppress a host finding")

    # --- real-tree structural pins (the graphs are not vacuously empty) ---
    root = root or repo_root()
    audit = run_host_audit(root)
    edges = audit["lock_edges"]
    check(
        any("MicroBatcher._cv" in e and "Metrics._lock" in e for e in edges),
        f"lock graph lost the real batcher->metrics edge: {edges}",
    )
    classes = audit["classes"]
    eng = classes.get("dgraph_tpu_torch/serve/engine.py::ServeEngine", {})
    check(
        {"degraded", "_consecutive_failures"} <= set(eng.get("guarded_fields", [])),
        f"guarded-field inference lost the engine's lock contract: {eng}",
    )
    bat = classes.get("dgraph_tpu_torch/serve/batcher.py::MicroBatcher", {})
    check(
        {"_q", "_inflight"} <= set(bat.get("guarded_fields", [])),
        f"guarded-field inference lost the batcher's lock contract: {bat}",
    )
    check(audit["chaos_points"] == 0,
          f"a chaos registry appeared ({audit['chaos_points']} points): pin its coverage")

    # --- the clean tree passes the full audit ---
    check(
        audit["ok"],
        "clean-tree host audit has findings: " + "; ".join(
            audit["failures"][:10]
        ),
    )
    return failures
