"""``python -m dgraph_tpu_torch.analysis.host`` — the host-side concurrency
& durability auditor's standalone CLI (counterpart of
``python -m dgraph_tpu.analysis.host``).

Default mode audits the port (per-file rules pragma-aware through the lint
machinery, plus the repo-level lock-order and chaos-coverage checks) and
exits nonzero on any finding; ``--selftest`` runs the per-rule fixture
pairs and the vacuity mutants, each of which must go RED, then the
clean-tree audit. Stdlib ``ast`` only. Every exit path carries a RunHealth
record.
"""

from __future__ import annotations

import dataclasses
import json

from dgraph_tpu_torch.analysis.host import host_selftest_failures, run_host_audit


@dataclasses.dataclass
class Config:
    """Host-side concurrency & durability auditor (``--selftest`` runs the
    fixture pairs + vacuity mutants + clean-tree audit; default mode audits
    the tree and exits nonzero on any finding)."""

    selftest: bool = False
    root: str = ""  # "" = the repo containing this package
    indent: int = 0


def main(cfg: Config) -> dict:
    from dgraph_tpu_torch.obs.health import RunHealth

    health = RunHealth.begin("analysis.host.cli")
    try:
        if cfg.selftest:
            failures = host_selftest_failures(cfg.root or None)
            out = {"kind": "host_selftest", "failures": failures}
        else:
            out = run_host_audit(cfg.root or None)
            failures = out["failures"]
        out["run_health"] = health.finish("; ".join(failures) if failures else None,
                                          wedge="stage_failure" if failures else None)
        print(json.dumps(out, indent=cfg.indent or None))
        if failures:
            raise SystemExit("host audit FAILED: " + "; ".join(failures[:10]))
        return out
    except SystemExit:
        raise
    except BaseException as e:  # every exit path carries a RunHealth record
        print(json.dumps({
            "kind": "host_audit",
            "failures": [f"crashed: {type(e).__name__}: {e}"],
            "run_health": health.finish(
                f"host audit crashed: {type(e).__name__}: {e}",
                wedge="interrupted" if isinstance(e, KeyboardInterrupt) else "stage_failure"),
        }))
        raise


if __name__ == "__main__":
    from dgraph_tpu_torch.utils.cli import parse_config

    main(parse_config(Config))
