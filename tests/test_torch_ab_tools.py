"""The A/B tools' CPU-checkable parts: each ``train.step_ab`` run is valid
Python once formatted, and the skewed ids that ``ops.kernel_ab`` and
``chip_smoke.py`` time kernel 2 on have the shape they promise (sorted,
padded, a hub of at least 10,000 edges at the arxiv shape). The timings
themselves need the card."""

import ast

import numpy as np
import pytest

import chip_smoke
from dgraph_tpu_torch.ops import kernel_ab
from dgraph_tpu_torch.train import step_ab


@pytest.mark.parametrize("config", sorted(step_ab._RUN))
def test_step_ab_runs_are_python(config):
    code = step_ab._RUN[config].format(steps=step_ab.STEPS, log="run.jsonl")
    tree = ast.parse(code)
    assert "STEP_MS" in code and tree.body
    assert step_ab.DEFAULT_DTYPES[config]


def test_power_law_ids():
    n, e_valid, e_pad = 169_344, 2_331_852, 2_332_672
    ids = kernel_ab.power_law_ids(n, e_valid, e_pad)
    assert ids.shape == (e_pad,) and ids.dtype == np.int32
    assert np.all(np.diff(ids) >= 0)
    assert np.all(ids[e_valid:] == n) and ids[:e_valid].max() < n
    assert np.bincount(ids[:e_valid], minlength=n).max() >= chip_smoke.MIN_HUB_DEGREE


@pytest.mark.parametrize("kernel,tag", [("sorted_segment_sum", "none"),
                                        ("sorted_segment_sum_bias_relu", "unw"),
                                        ("sorted_segment_sum_act", "unw")])
def test_segment_sum_bounds_count_the_offsets_not_the_ids(kernel, tag):
    """The segment sums read the CSR offsets their wrappers cached, not the
    ids: at zero columns an unweighted call's bytes are the offsets' alone,
    whatever the number of edges."""
    n = 169_344
    for e in (1_000, 2_332_672):
        nbytes, ops = chip_smoke.main_shape_bytes(kernel, tag, e, e, n, 0, 4)
        assert (nbytes, ops) == (8 * (n + 1), 0)
