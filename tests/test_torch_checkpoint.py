"""The port's train-state checkpoints (``dgraph_tpu_torch/train/checkpoint.py``)
held against the reference's (``dgraph_tpu/train/checkpoint.py``, orbax).

Each layout of good and bad steps is built twice, in two directories, by
each package's own ``save_checkpoint`` from the same numpy values, and
damaged the same way (every file of a step truncated to 3 bytes, as
``tests/test_serve.py:515-523`` does). Then each package's restore runs on
its own directory, and the two must agree on:

- the step restored, or the exception class (``FileNotFoundError`` or any
  other);
- ``all_steps`` and ``quarantined_steps`` afterwards;
- the "quarantined" and "falling back" warnings of the load, and of a
  second load (none quarantined there);
- ``checkpoint_keys`` before and after;
- the restored values, bit for bit.

Beside: a killed save leaves no step ``all_steps`` lists, a save replaces
an existing step, the template checks shapes and dtypes, and over two gloo
ranks global rank 0 resolves the step while every rank restores bit-equal
tensors (and raises together when rank 0 cannot).
"""

import glob
import logging
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from dgraph_tpu.train import checkpoint as ref
from dgraph_tpu_torch.comm.dist import launch
from dgraph_tpu_torch.train import checkpoint as port

import torch_dist_ranks

STEPS = (1, 2, 3)
LOGGERS = {ref: "dgraph_tpu.checkpoint", port: "dgraph_tpu_torch.checkpoint"}


def values(step: int, extra: bool = False) -> dict:
    """Step ``step``'s state as numpy (``extra``: one more key, the schema
    of a newer program)."""
    params = {"w": np.full((3, 2), step, np.float32)
              + np.arange(6, dtype=np.float32).reshape(3, 2),
              "b": np.arange(4, dtype=np.float32) * -0.5 + step}
    if extra:
        params["extra"] = np.ones(2, np.float32)
    return {"params": params, "step": step}


def to_pkg(pkg, tree):
    if isinstance(tree, dict):
        return {k: to_pkg(pkg, v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and pkg is port:
        return torch.from_numpy(tree.copy())
    return tree


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if hasattr(tree, "__array__") and not isinstance(tree, (int, float)):
        return np.asarray(tree)
    return tree


def template(pkg) -> dict:
    return to_pkg(pkg, {"params": {"w": np.zeros((3, 2), np.float32),
                                   "b": np.zeros(4, np.float32)}, "step": 0})


def truncate_step(ckpt: str, step: int) -> int:
    """Every file of step ``step`` cut to 3 bytes; the files cut."""
    n = 0
    root = os.path.join(ckpt, f"step_{step:08d}")
    for p in glob.glob(os.path.join(root, "**", "*"), recursive=True):
        if os.path.isfile(p):
            with open(p, "r+b") as f:
                f.truncate(3)
            n += 1
    return n


# layout -> (the steps saved with a newer schema, the steps truncated, the
# restore's step, a template or the raw tree); "quarantined_renamed_back"
# loads once and renames the quarantined step back before its loads
LAYOUTS = {
    "intact": ((), (), None, True),
    "intact_raw": ((), (), None, False),
    "newest_truncated": ((), (3,), None, True),
    "newest_truncated_raw": ((), (3,), None, False),
    "every_step_truncated": ((), STEPS, None, True),
    "named_corrupt": ((), (2,), 2, True),
    "named_missing": ((), (), 7, True),
    "named_intact": ((), (3,), 1, True),
    "newest_other_schema": ((3,), (), None, True),
    "newest_other_schema_raw": ((3,), (), None, False),
    "quarantined_renamed_back": ((), (3,), None, True),
    "empty_dir": None,
    "no_dir": None,
}


def build(pkg, ckpt: str, layout: str) -> None:
    if layout == "no_dir":
        return
    os.makedirs(ckpt)
    if layout == "empty_dir":
        return
    schema, truncated, _, _ = LAYOUTS[layout]
    for s in STEPS:
        pkg.save_checkpoint(ckpt, to_pkg(pkg, values(s, extra=s in schema)), s)
    for s in truncated:
        assert truncate_step(ckpt, s) > 0
    if layout == "quarantined_renamed_back":
        # a first load quarantines step 3; the operator renames it back
        pkg.restore_checkpoint(ckpt, template(pkg))
        os.replace(os.path.join(ckpt, "step_00000003.corrupt"),
                   os.path.join(ckpt, "step_00000003"))


class Warnings(logging.Handler):
    def __init__(self, name):
        super().__init__(logging.WARNING)
        self.messages, self.logger = [], logging.getLogger(name)

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)

    def counts(self) -> dict:
        return {what: sum(what in m for m in self.messages)
                for what in ("quarantined to", "falling back", "NOT quarantining")}


def load(pkg, ckpt: str, layout: str) -> tuple:
    _, _, step, with_template = LAYOUTS.get(layout) or ((), (), None, True)
    with Warnings(LOGGERS[pkg]) as w:
        try:
            got = pkg.restore_checkpoint(ckpt, template(pkg) if with_template else None,
                                         step=step)
            result = ("none",) if got is None else ("state", to_numpy(got))
        except FileNotFoundError:
            result = ("error", "FileNotFoundError")
        except Exception:  # noqa: BLE001 — the class compared is "any other"
            result = ("error", "other")
    return result, w.counts()


def outcome(pkg, ckpt: str, layout: str) -> dict:
    build(pkg, ckpt, layout)
    keys_before = pkg.checkpoint_keys(ckpt)
    first, warned = load(pkg, ckpt, layout)
    out = {"result": first, "warned": warned, "keys_before": keys_before,
           "all_steps": pkg.all_steps(ckpt), "quarantined": pkg.quarantined_steps(ckpt),
           "keys_after": pkg.checkpoint_keys(ckpt)}
    out["second"], out["warned_again"] = load(pkg, ckpt, layout)
    return out


def assert_trees_bit_equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_trees_bit_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=where)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_restore_rules_match_the_reference(tmp_path, layout):
    want = outcome(ref, str(tmp_path / "ref"), layout)
    got = outcome(port, str(tmp_path / "port"), layout)
    for k in ("warned", "warned_again", "keys_before", "keys_after", "all_steps",
              "quarantined"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["warned_again"]["quarantined to"] == 0
    for k in ("result", "second"):
        assert got[k][0] == want[k][0] and len(got[k]) == len(want[k]), (k, got[k], want[k])
        if got[k][0] == "state":
            assert_trees_bit_equal(got[k][1], want[k][1], k)
        elif got[k][0] == "error":
            assert got[k][1] == want[k][1], (k, got[k], want[k])


def test_layouts_cover_the_rules(tmp_path):
    """The layouts reach each rule: a fallback that quarantines, one that
    keeps a schema mismatch, a failure that quarantines nothing."""
    seen = {layout: outcome(port, str(tmp_path / layout), layout)
            for layout in ("newest_truncated", "newest_other_schema", "every_step_truncated")}
    assert seen["newest_truncated"]["quarantined"] == [3]
    assert seen["newest_truncated"]["result"][1]["step"] == 2
    assert seen["newest_other_schema"]["quarantined"] == []
    assert seen["newest_other_schema"]["warned"]["NOT quarantining"] == 1
    assert seen["every_step_truncated"]["result"] == ("error", "other")
    assert seen["every_step_truncated"]["all_steps"] == list(STEPS)


KILLED_SAVE = """
import os, signal, sys
import torch
from dgraph_tpu_torch.train import checkpoint
ckpt, at = sys.argv[1], int(sys.argv[2])
calls = {"n": 0}
real = os.fsync
def fsync(fd):
    calls["n"] += 1
    if calls["n"] == at:
        os.kill(os.getpid(), signal.SIGKILL)
    real(fd)
os.fsync = fsync
checkpoint.save_checkpoint(ckpt, {"params": {"w": torch.full((4,), 9.0)}, "step": 2}, 2)
"""


@pytest.mark.parametrize("at", [1, 2, 3])
def test_a_killed_save_leaves_no_step(tmp_path, at):
    """A save killed at its first, second or third fsync (the key file, the
    state, the step directory) leaves only its temporary directory, which
    ``all_steps`` does not list: the older step still restores."""
    ckpt = str(tmp_path / "ckpt")
    port.save_checkpoint(ckpt, {"params": {"w": torch.ones(4)}, "step": 1}, 1)
    p = subprocess.run([sys.executable, "-c", KILLED_SAVE, ckpt, str(at)], cwd=os.getcwd(),
                       capture_output=True, timeout=120)
    assert p.returncode == -signal.SIGKILL, p.stderr.decode()[-2000:]
    left = sorted(os.listdir(ckpt))
    assert left[0] == "step_00000001" and left[1].startswith("step_00000002.tmp.")
    assert port.all_steps(ckpt) == [1] and port.quarantined_steps(ckpt) == []
    got = port.restore_checkpoint(ckpt)
    assert got["step"] == 1 and torch.equal(got["params"]["w"], torch.ones(4))
    port.save_checkpoint(ckpt, {"params": {"w": torch.zeros(4)}, "step": 2}, 2)
    assert port.latest_step(ckpt) == 2 and port.restore_checkpoint(ckpt)["step"] == 2


def test_save_replaces_a_step_and_keeps_every_bit(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    gen = torch.Generator().manual_seed(0)
    state = {"f32": torch.randn(5, 3, generator=gen), "bf16": torch.randn(7, generator=gen)
             .bfloat16(), "f64": torch.randn(2, generator=gen).double(),
             "i64": torch.arange(6), "nan": torch.tensor([float("nan"), -0.0, float("inf")]),
             "view": torch.randn(4, 4, generator=gen)[:, 1], "nested": [{"a": 1.5}, (2, None)]}
    port.save_checkpoint(ckpt, {"old": torch.zeros(1)}, 5)
    port.save_checkpoint(ckpt, state, 5)
    assert sorted(os.listdir(ckpt)) == ["step_00000005"]
    got = port.restore_checkpoint(ckpt, state)
    assert port.checkpoint_keys(ckpt) == set(state)
    for k in ("f32", "bf16", "f64", "i64", "nan", "view"):
        assert got[k].dtype == state[k].dtype and got[k].shape == state[k].shape
        assert got[k].view(-1).contiguous().view(torch.uint8).tolist() == \
            state[k].contiguous().view(-1).view(torch.uint8).tolist(), k
    assert got["nested"] == [{"a": 1.5}, (2, None)]


@pytest.mark.parametrize("bad", ["shape", "dtype", "key", "leaf"])
def test_template_mismatch_raises(tmp_path, bad):
    ckpt = str(tmp_path / "ckpt")
    port.save_checkpoint(ckpt, {"params": {"w": torch.ones(3)}, "step": 1}, 1)
    tmpl = {"params": {"w": torch.zeros(3)}, "step": 0}
    assert port.restore_checkpoint(ckpt, tmpl, step=1)["step"] == 1
    tmpl["params"] = {"shape": {"w": torch.zeros(4)}, "dtype": {"w": torch.zeros(3).double()},
                      "key": {"w": torch.zeros(3), "b": torch.zeros(1)},
                      "leaf": {"w": 0.0}}[bad]
    with pytest.raises(port.TemplateMismatch):
        port.restore_checkpoint(ckpt, tmpl, step=1)
    # readable raw: a schema mismatch, never quarantined
    with pytest.raises(port.TemplateMismatch):
        port.restore_checkpoint(ckpt, tmpl)
    assert port.all_steps(ckpt) == [1] and port.quarantined_steps(ckpt) == []


def test_atomic_pickle_dump_replaces_whole(tmp_path):
    path = str(tmp_path / "a.pkl")
    port.atomic_pickle_dump(path, {"x": 1})
    port.atomic_pickle_dump(path, {"x": 2})
    assert os.listdir(tmp_path) == ["a.pkl"]
    import pickle

    with open(path, "rb") as f:
        assert pickle.load(f) == {"x": 2}


@pytest.mark.parametrize("layout", ["newest_truncated", "every_step_truncated", "empty"])
def test_restore_agreed_over_two_ranks(tmp_path, layout):
    """Global rank 0 resolves the step (quarantining once), every rank
    restores it by name and holds bit-equal tensors; when rank 0's restore
    raises, every rank raises (the launch fails, no rank hangs)."""
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    if layout != "empty":
        for s in STEPS:
            port.save_checkpoint(ckpt, to_pkg(port, values(s)), s)
        for s in (STEPS if layout == "every_step_truncated" else (3,)):
            truncate_step(ckpt, s)
    if layout == "every_step_truncated":
        # rank 0 raises its own error, rank 1 "global rank 0 failed"
        with pytest.raises(RuntimeError, match="rank [01] of 2 failed"):
            launch(torch_dist_ranks.restore_agreed_rank, 2, ckpt, device="cpu", timeout=120,
                   threads=1)
        assert port.all_steps(ckpt) == list(STEPS) and port.quarantined_steps(ckpt) == []
        return
    res = launch(torch_dist_ranks.restore_agreed_rank, 2, ckpt, device="cpu", timeout=120,
                 threads=1)
    if layout == "empty":
        assert [r["step"] for r in res] == [None, None]
        return
    assert [r["step"] for r in res] == [2, 2]
    assert port.quarantined_steps(ckpt) == [3] and port.all_steps(ckpt) == [1, 2, 9]
    want = values(2)["params"]
    for r in res:
        assert_trees_bit_equal(r["params"], want)
    # the write: rank 0 alone, before the barrier every rank passes
    assert [r["saved_seen"] for r in res] == [True, True]
    assert port.latest_step(ckpt) == 9
