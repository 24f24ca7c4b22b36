"""Structured run health records — counterpart of ``dgraph_tpu/obs/health.py``.

:class:`RunHealth` is one JSON-able record of a run component: host and
environment context, wall time, the commit (``git_rev``) and a wedge
classification of how it ended. Every analysis CLI reports through it on
each exit path, as the reference's do. Stdlib only.

The record keeps the reference's fields (schema 1), so one reader takes
both packages' records; the fields the reference fills from its backend
probes (``probes``, ``events``, ``backend``) stay empty here, since nothing
in the port probes a backend. The wedge taxonomy is the reference's
(:func:`classify_wedge`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

SCHEMA_VERSION = 1

WEDGE_KINDS = (
    "none",
    "init_wedge",
    "init_failure",
    "dispatch_wedge",
    "backend_lost",
    "watchdog_timeout",
    "interrupted",
    "stage_failure",
    "unknown",
)

# env prefixes worth snapshotting (flags that change behavior; no secrets)
_ENV_PREFIXES = ("DGRAPH_", "TORCH_", "CUDA_", "NCCL_")


def classify_wedge(error: Optional[str], probes: Optional[list] = None) -> str:
    """Map an exit-path error string + probe history to the taxonomy."""
    if not error:
        return "none"
    e = error.lower()
    hung_probes = any(p.get("outcome") == "hang" for p in probes or [])
    # a stage exception's text may hold any of the words scanned below
    if "stage failed" in e:
        return "stage_failure"
    if "watchdog" in e and "past its own watchdog" not in e:
        return "watchdog_timeout"
    if "never initialized" in e or "backend init failed" in e:
        return "init_wedge" if hung_probes else "init_failure"
    if "backend is" in e or ("backend" in e and "lost" in e):
        return "backend_lost"
    if "hung" in e or "wedge" in e:
        return "dispatch_wedge"
    if "signal" in e or "interrupt" in e:
        return "interrupted"
    return "unknown"


_GIT_REV: Optional[str] = None


def git_rev() -> str:
    """``git rev-parse --short HEAD`` of the checkout this file lives in,
    or ``"unknown"`` (never an exception). Cached per process."""
    global _GIT_REV
    if _GIT_REV is None:
        import subprocess

        try:
            p = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=5,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            )
            rev = (p.stdout or "").strip()
            _GIT_REV = rev if p.returncode == 0 and rev else "unknown"
        except (OSError, subprocess.SubprocessError):
            _GIT_REV = "unknown"
    return _GIT_REV


def _host_snapshot() -> dict:
    import platform
    import socket

    return {
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "platform": platform.platform(),
        "python": platform.python_version(),
    }


def _env_snapshot() -> dict:
    return {k: v for k, v in os.environ.items()
            if any(k.startswith(p) for p in _ENV_PREFIXES)}


@dataclasses.dataclass
class RunHealth:
    """Accumulating health record for one run component. All fields
    JSON-serializable."""

    component: str
    started_at: str
    host: dict
    env: dict
    probes: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    backend: Optional[dict] = None
    wedge: str = "none"
    error: Optional[str] = None
    wall_s: Optional[float] = None
    trace_id: Optional[str] = None
    git_rev: Optional[str] = None
    schema: int = SCHEMA_VERSION
    _t0: float = dataclasses.field(default=0.0, repr=False)

    @classmethod
    def begin(cls, component: str) -> "RunHealth":
        return cls(
            component=component,
            started_at=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            host=_host_snapshot(),
            env=_env_snapshot(),
            trace_id=os.environ.get("DGRAPH_TRACE_ID") or None,
            git_rev=git_rev(),
            _t0=time.perf_counter(),
        )

    def finish(self, error: Optional[str] = None, wedge: Optional[str] = None) -> dict:
        """Seal the record: stamp wall time, classify, return to_dict()."""
        self.error = error
        self.wedge = wedge if wedge is not None else classify_wedge(error, self.probes)
        self.wall_s = round(time.perf_counter() - self._t0, 1)
        return self.to_dict()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("_t0")
        return d
