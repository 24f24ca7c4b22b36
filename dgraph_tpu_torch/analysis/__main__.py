"""``python -m dgraph_tpu_torch.analysis`` — the port's static-analysis CLI:
the contract linter, the host-side concurrency & durability auditor and the
put-discipline verifier of the one-sided halo transport (tiers ``lint``,
``host`` and ``kernel``), one JSON line out, nonzero exit on any finding.

Default mode lints ``dgraph_tpu_torch/`` and ``chip_smoke.py``, audits the
host code's lock graph and chaos coverage, and runs the kernel tier's audit
(the train and eval steps of the canonical workload at ``--world`` ranks,
gloo on the CPU, every transport call verified and counted).

``--selftest`` adds every vacuity guard: the lint rules' fixture pairs and
a clean-tree lint, the host tier's fixtures and mutants and its clean-tree
audit, the kernel tier's seeded faults (the clean protocol GREEN, each of
the five faults RED naming its rule) and its audit at 2 and 4 ranks. The
kernel tier's landing check needs a device and runs in
``python -m dgraph_tpu_torch.analysis.kernel``.

``--list_rules`` prints the lint-rule registry (name, scope, description).
The reference's trace, HLO and SPMD tiers are replaced by a
collective-schedule audit in a later slice. Every exit path carries a
RunHealth record.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class Config:
    """Static analysis of the port (``--selftest`` for every vacuity guard;
    ``--list_rules`` for the rule registry)."""

    selftest: bool = False
    list_rules: bool = False
    lint: bool = True
    host: bool = True
    kernel: bool = True
    root: str = ""  # lint root; "" = the repo containing this package
    world: int = 2  # the kernel audit's world size (default mode)
    seed: int = 0
    indent: int = 0


def _rule_catalog() -> dict:
    from dgraph_tpu_torch.analysis.lint import RULES

    return {"kind": "rule_catalog",
            "rules": [{"name": r.name, "scope": r.scope, "description": r.description}
                      for r in sorted(RULES.values(), key=lambda r: r.name)]}


def run(cfg: Config) -> dict:
    """The tiers ``cfg`` selects; ``failures`` lists every finding."""
    from dgraph_tpu_torch.analysis import host, kernel, lint
    from dgraph_tpu_torch.analysis.trace import build_audit_workload

    failures: list = []
    out: dict = {"kind": "analysis_selftest" if cfg.selftest else "analysis_report"}
    root = cfg.root or None
    if cfg.lint:
        if cfg.selftest:
            failures.extend(lint.lint_selftest_failures())
        rep = lint.run_lint(root)
        out["lint"] = {"files_checked": rep["files_checked"], "findings": rep["findings"]}
        failures.extend(f"{f['rule']} {f['path']}:{f['line']}: {f['message']}"
                        for f in rep["findings"])
    if cfg.host:
        if cfg.selftest:
            failures.extend(host.host_selftest_failures(root))
        # the per-file host rules already ran in the lint pass above
        rep = host.run_host_audit(root, file_rules=not cfg.lint)
        out["host_audit"] = {"ok": rep["ok"], "lock_edges": rep["lock_edges"],
                             "chaos_points": rep["chaos_points"]}
        failures.extend(rep["failures"])
    if cfg.kernel:
        if cfg.selftest:
            failures.extend(kernel.kernel_selftest_failures())
        out["kernel_audit"] = {}
        for world in ((2, 4) if cfg.selftest else (cfg.world,)):
            rep = kernel.audit_workload_kernels(build_audit_workload(world, seed=cfg.seed))
            out["kernel_audit"][str(world)] = {"ok": rep["ok"], "transports": len(rep["kernels"]),
                                               "num_halo_deltas": rep["num_halo_deltas"]}
            failures.extend(rep["failures"])
    out["failures"] = failures
    out["ok"] = not failures
    return out


def main(cfg: Config) -> dict:
    from dgraph_tpu_torch.obs.health import RunHealth

    health = RunHealth.begin("analysis.cli")
    try:
        if cfg.list_rules:
            out = _rule_catalog()
            print(json.dumps(out, indent=cfg.indent or None))
            return out
        out = run(cfg)
        failures = out["failures"]
        out["run_health"] = health.finish("; ".join(failures) if failures else None,
                                          wedge="stage_failure" if failures else None)
        print(json.dumps(out, indent=cfg.indent or None))
        if failures:
            raise SystemExit("analysis FAILED: " + "; ".join(failures[:10]))
        return out
    except SystemExit:
        raise
    except BaseException as e:  # every exit path carries a RunHealth record
        print(json.dumps({
            "kind": "analysis_report",
            "failures": [f"crashed: {type(e).__name__}: {e}"],
            "run_health": health.finish(
                f"analysis failed: {type(e).__name__}: {e}",
                wedge="interrupted" if isinstance(e, KeyboardInterrupt) else "stage_failure"),
        }))
        raise


if __name__ == "__main__":
    from dgraph_tpu_torch.utils.cli import parse_config

    main(parse_config(Config))
