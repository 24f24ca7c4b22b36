"""The hub route of the sorted segment sums (kernels 1, 1a and 2) on the CPU.

The route's plan (``ops.segment.hub_plan``) cuts every row of more than
HUB_DEGREE edges into chunks of at most HUB_CHUNK edges; the kernels sum
each chunk into an f32 partial row and add the partials in a fixed order.
Here the plan is held to the CSR offsets it is cut from (every hub edge in
exactly one chunk, in order, no chunk across rows, nothing else in any
chunk), its cache to the CSR offsets' rules, and the route's arithmetic
(``hub_split_sum_plain``) to the plain versions of the three entry points:
exactly on multiples of 1/4 (whose f32 sums are exact in any order), within
1e-6 relative on random f32. The kernels themselves are held to the same
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3). Also: ``Communicator.init_process_group`` runs
a rank on the card unless the caller asks for the CPU.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dgraph_tpu_torch.comm import Communicator
from dgraph_tpu_torch.data.synthetic import ARXIV_NODES, skewed_arxiv_edges
from dgraph_tpu_torch.ops import kernel_ab
from dgraph_tpu_torch.ops import segment as seg

N = 120
DEGREE, CHUNK = 16, 5  # small constants, so that small ids hold many hubs


def _hub_ids(seed=0, pad=30):
    """Sorted ids over N rows: empty rows, rows of exactly DEGREE edges,
    hubs of a multiple of CHUNK edges and not, a hub first and last, then
    padded ids equal to N."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 4, N)
    deg[rng.choice(N, 20, replace=False)] = 0
    deg[[0, 7, 9, 10, 60, N - 1]] = (DEGREE + 1, DEGREE, 4 * CHUNK, 3 * CHUNK + 2, 40, 23)
    ids = np.repeat(np.arange(N), deg)
    return np.concatenate([ids, np.full(pad, N)]).astype(np.int32)


IDS = _hub_ids()


def _want_chunks(ids: np.ndarray, n: int, degree: int, chunk: int) -> list:
    """[(row, first edge, end edge)] of every hub row, in row order."""
    row_ptr = np.searchsorted(ids, np.arange(n + 1), side="left")
    out = []
    for r in range(n):
        a, b = row_ptr[r], row_ptr[r + 1]
        if b - a > degree:
            out += [(r, s, min(s + chunk, b)) for s in range(a, b, chunk)]
    return out


@pytest.mark.parametrize("degree,chunk", [(DEGREE, CHUNK), (DEGREE, DEGREE), (3, 1),
                                          (40, 7), (100, 10)])
def test_hub_plan_covers_each_hub_edge_once_in_order(degree, chunk):
    ids = torch.from_numpy(IDS)
    row_ptr = seg._row_ptr(ids, N)
    hub = seg.hub_plan(row_ptr, degree, chunk)
    want = _want_chunks(IDS, N, degree, chunk)
    if not want:
        assert hub is None
        return
    row, start, end = hub.chunks.tolist()
    assert list(zip(row, start, end)) == want
    assert hub.chunks.dtype == torch.int64 and hub.first.dtype == torch.int64
    assert hub.n_chunks == len(want) and hub.degree == degree
    # each hub's chunks are contiguous, start at the row's first edge and
    # end at its last; the hubs are the rows of more than `degree` edges
    deg = np.diff(row_ptr.numpy())
    hubs = np.flatnonzero(deg > degree)
    assert hub.n_hubs == len(hubs) and hub.first.tolist()[-1] == hub.n_chunks
    first = hub.first.tolist()
    for h, r in enumerate(hubs):
        cs = range(first[h], first[h + 1])
        assert {row[c] for c in cs} == {r}
        assert start[first[h]] == row_ptr[r] and end[first[h + 1] - 1] == row_ptr[r + 1]
        assert all(end[c] == start[c + 1] for c in cs[:-1])
        assert all(0 < end[c] - start[c] <= chunk for c in cs)
    # every edge in a chunk is a hub edge: no non-hub row, no padded id
    covered = np.zeros(len(IDS), int)
    for s, e in zip(start, end):
        covered[s:e] += 1
    assert set(covered) <= {0, 1}
    np.testing.assert_array_equal(covered.astype(bool), np.isin(IDS, hubs))


def test_no_hubs_gives_no_plan():
    ids = torch.from_numpy(np.repeat(np.arange(N), 3).astype(np.int32))
    assert seg.hub_plan(seg._row_ptr(ids, N), 3, 2) is None
    assert seg.segment_plan(ids, N).hub is None
    assert seg.hub_args(None, 8, "cpu") == ((None, None, 0, 0, 0, None), None)


def test_hub_args_point_into_the_plan_and_a_workspace():
    hub = seg.hub_plan(seg._row_ptr(torch.from_numpy(IDS), N), DEGREE, CHUNK)
    args, ws = seg.hub_args(hub, 33, "cpu")
    assert ws.shape == (hub.n_chunks, 33) and ws.dtype == torch.float32
    assert args == (hub.chunks.data_ptr(), hub.first.data_ptr(), hub.n_chunks, hub.n_hubs,
                    DEGREE, ws.data_ptr())


# --- the plan beside the CSR offsets, computed once per ids tensor -----------


def test_segment_plan_is_computed_once_per_ids_tensor():
    ids = torch.from_numpy(_hub_ids(1))
    before = seg.csr_offsets.computed
    a = seg.segment_plan(ids, N)
    assert seg.segment_plan(ids, N) is a and seg.csr_offsets(ids, N) is a.row_ptr
    assert seg.csr_offsets.computed == before + 1
    want = seg.hub_plan(seg._row_ptr(ids, N))
    assert (a.hub is None) == (want is None)
    if want is not None:
        assert torch.equal(a.hub.chunks, want.chunks) and torch.equal(a.hub.first, want.first)


def test_segment_plan_holds_the_modules_constants():
    ids = np.repeat(np.arange(4), [seg.HUB_DEGREE + 1, seg.HUB_DEGREE, 2 * seg.HUB_CHUNK + 3,
                                   1]).astype(np.int32)
    plan = seg.segment_plan(torch.from_numpy(ids), 4)
    assert plan.hub.n_hubs == 2 and plan.hub.degree == seg.HUB_DEGREE
    assert plan.hub.chunks[0].tolist().count(2) == -(-(2 * seg.HUB_CHUNK + 3) // seg.HUB_CHUNK)


@pytest.mark.parametrize("edit", ["in_place", "through_a_view"])
def test_segment_plan_is_computed_again_after_an_in_place_edit(edit):
    # IDS with every edge three times: no row above HUB_DEGREE, half the
    # edges above it
    ids = torch.from_numpy(np.concatenate([np.repeat(IDS[IDS < N], 3),
                                           np.full(30, N, np.int32)]))
    stale = seg.segment_plan(ids, N)
    before = seg.csr_offsets.computed
    if edit == "in_place":
        ids.clamp_(min=N // 2)  # the first half's edges fold into one row
    else:
        ids[: len(ids) // 2].zero_()  # half the edges into row 0
    got = seg.segment_plan(ids, N)
    assert seg.csr_offsets.computed == before + 1 and got is not stale
    assert stale.hub is None and got.hub is not None  # a hub at the module's constants
    want = _want_chunks(ids.numpy(), N, seg.HUB_DEGREE, seg.HUB_CHUNK)
    assert (got.hub.chunks.T.tolist() if got.hub is not None else []) == [list(c) for c in want]
    assert seg.segment_plan(ids, N) is got


def test_segment_plan_of_inference_tensors_is_never_cached():
    before = seg.csr_offsets.computed
    with torch.inference_mode():
        ids = torch.from_numpy(IDS.copy()) + 0
        a = seg.segment_plan(ids, N)
        b = seg.segment_plan(ids, N)
    assert seg.csr_offsets.computed == before + 2 and a is not b


# --- the route's arithmetic against the plain versions ----------------------


def _quarters(rng, *shape, lo=-8, hi=9):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32) / 4)


def _plain(kernel, data, ids, bias, w, input_op):
    if kernel == "sum":
        return seg.sorted_segment_sum_plain(data, ids, N, input_op=input_op)
    fn = (seg.sorted_segment_sum_act_plain if kernel == "act"
          else seg.sorted_segment_sum_bias_relu_plain)
    return fn(data, ids, bias, N, edge_weight=w)


def _split(kernel, data, ids, bias, w, input_op, degree, chunk):
    if kernel == "sum":
        return seg.hub_split_sum_plain(data, ids, N, input_op=input_op, degree=degree,
                                       chunk=chunk)
    return seg.hub_split_sum_plain(data, ids, N, bias=bias, edge_weight=w, act=kernel == "act",
                                   degree=degree, chunk=chunk)


FORMS = [("sum", "none", False), ("sum", "relu", False), ("bias_relu", None, True),
         ("bias_relu", None, False), ("act", None, True), ("act", None, False)]


@pytest.mark.parametrize("degree,chunk", [(DEGREE, CHUNK), (3, 1), (40, 7)])
@pytest.mark.parametrize("kernel,input_op,weighted", FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 33])
def test_hub_split_sum_is_exact_on_quarters(F, dtype, kernel, input_op, weighted, degree,
                                            chunk):
    rng = np.random.default_rng(F)
    ids = torch.from_numpy(IDS)
    data = _quarters(rng, len(IDS), F).to(dtype)
    bias = _quarters(rng, N, F).to(dtype)
    w = _quarters(rng, len(IDS), lo=0, hi=5) if weighted else None
    got = _split(kernel, data, ids, bias, w, input_op, degree, chunk)
    want = _plain(kernel, data, ids, bias, w, input_op)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("kernel,input_op,weighted", FORMS)
def test_hub_split_sum_matches_plain_on_random_f32(kernel, input_op, weighted):
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(IDS)
    data = torch.from_numpy(rng.normal(size=(len(IDS), 8)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(N, 8)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=len(IDS)).astype(np.float32)) if weighted else None
    got = _split(kernel, data, ids, bias, w, input_op, DEGREE, CHUNK)
    want = _plain(kernel, data, ids, bias, w, input_op)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_hub_split_sum_differs_when_a_chunk_is_dropped(monkeypatch):
    """The exact comparison above sees a plan that misses a hub edge."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(IDS)
    data = _quarters(rng, len(IDS), 4, lo=1)
    real = seg.hub_plan

    def short(row_ptr, degree, chunk):
        h = real(row_ptr, degree, chunk)
        chunks = h.chunks.clone()
        chunks[2, 0] -= 1  # the first chunk loses its last edge
        return h._replace(chunks=chunks)

    monkeypatch.setattr(seg, "hub_plan", short)
    got = seg.hub_split_sum_plain(data, ids, N, degree=DEGREE, chunk=CHUNK)
    assert not torch.equal(got, seg.sorted_segment_sum_plain(data, ids, N))


# --- the ids the card runs it on --------------------------------------------


def test_skewed_arxiv_edges_hold_hubs():
    e = skewed_arxiv_edges()
    assert e.shape == (2, 2 * 1_166_243) and e.dtype == np.int64
    assert e.max() < ARXIV_NODES
    np.testing.assert_array_equal(e[:, :e.shape[1] // 2], e[::-1, e.shape[1] // 2:])
    deg = np.bincount(e[1], minlength=ARXIV_NODES)
    assert deg.max() == 15_001 and (deg > 1024).sum() == 36


def test_hub_edge_case_ids():
    n = 3000
    ids = kernel_ab.hub_edge_case_ids(n, seg.HUB_DEGREE, seg.HUB_CHUNK)
    assert np.all(np.diff(ids) >= 0) and np.all(ids[-300:] == n)
    deg = np.bincount(ids, minlength=n + 1)
    m = deg[40]
    assert m % seg.HUB_CHUNK == 0 and m > seg.HUB_DEGREE and deg[47] == m + 7
    assert deg[0] == deg[41] == seg.HUB_DEGREE + 1 and deg[3] == seg.HUB_DEGREE
    assert deg[n - 1] > seg.HUB_DEGREE and deg[:n][deg[:n] > seg.HUB_DEGREE].size == 5


def test_launch_counts_carry_the_hub_route():
    seg.reset_launch_counts()
    counts = seg.launch_counts()
    assert {k for k in counts if k.endswith(".hub_calls")} == {
        f"{k}.hub_calls" for k in seg.HUB_ROUTE}
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("hubs,hub_rows,n,ok", [
    (False, [], 0, True), (False, [], 1, False), (False, [[0]], 4, True),
    (False, [[0]], 5, False), (False, [[0], [0, 7]], 0, False),
    (True, None, 0, False), (True, None, 3, True), (True, None, 5, False)])
def test_step_launch_check_reads_the_hub_route(hubs, hub_rows, n, ok):
    """On the SBM graph no call takes the route unless a plan's only hub
    is its padded src row 0, and then at most every call; on a graph with
    hubs some call of each launching sorted sum takes it."""
    counts = dict(seg.launch_counts(), sorted_segment_sum=4)
    counts["sorted_segment_sum.hub_calls"] = n
    args = ("t", 0, counts, {"sorted_segment_sum": 4}, hubs, hub_rows)
    if ok:
        chip_smoke.check_step_launches(*args)
    else:
        with pytest.raises(SystemExit):
            chip_smoke.check_step_launches(*args)


def test_cached_hub_rows_reads_the_plans_of_live_ids():
    ids = torch.from_numpy(np.repeat(np.arange(5), [seg.HUB_DEGREE + 1, 1, 0,
                                                    2 * seg.HUB_DEGREE, 3]).astype(np.int32))
    seg.segment_plan(ids, 5)
    assert [0, 3] in chip_smoke.cached_hub_rows()
    del ids
    assert [0, 3] not in chip_smoke.cached_hub_rows()


# --- Communicator.init_process_group follows the device rule -----------------


def test_communicator_without_a_card_or_a_device_raises(monkeypatch, tmp_path):
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("gloo", "nccl"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Communicator.init_process_group(backend, init_method=f"file://{tmp_path}/s")
    assert not dist.is_initialized()


def test_communicator_on_the_cpu_when_asked(tmp_path):
    import torch.distributed as dist

    comm = Communicator.init_process_group("gloo", device="cpu",
                                           init_method=f"file://{tmp_path}/store")
    try:
        assert comm.group.device == torch.device("cpu") and comm.get_world_size() == 1
        assert torch.equal(comm.all_reduce_sum(torch.ones(3)), torch.ones(3))
    finally:
        dist.destroy_process_group()


# --- where the SBM cells meet the route: the padded src row ------------------


def test_a_padded_plan_puts_every_padded_edge_in_src_row_0():
    """Kernel 2's src-side ids (``halo_sorted_ids``) give every padded edge
    src id 0, so row 0 of bench_gcn's uniform arxiv-shaped plan holds its
    13 real edges and the 186 padded ones: 199, under HUB_DEGREE, so that
    plan has no hub and phase 6 takes no hub route. The owner side pads
    with an id out of range and has no hub."""
    from dgraph_tpu_torch.data.synthetic import ARXIV_EDGES, random_edges
    from dgraph_tpu_torch.plan import build_edge_plan

    plan, _ = build_edge_plan(random_edges(ARXIV_NODES, ARXIV_EDGES, seed=0),
                              np.zeros(ARXIV_NODES, np.int32), world_size=1,
                              edge_owner="dst", pad_multiple=128)
    p = plan.shard(0)
    row_ptr = seg._row_ptr(p.halo_sorted_ids, p.n_src_pad)
    assert int(row_ptr[1] - row_ptr[0]) == 199 <= seg.HUB_DEGREE
    assert seg.hub_plan(row_ptr) is None
    assert p.e_pad - int((p.dst_index < p.n_dst_pad).sum()) == 186
    assert seg.hub_plan(seg._row_ptr(p.dst_index, p.n_dst_pad)) is None


def test_a_plan_padded_past_hub_degree_has_src_row_0_as_its_only_hub():
    """The CLI's plan pads its edges to a multiple of 1024 (384 padded
    edges for this SBM graph, 820 for the arxiv-width one): src row 0 then
    holds more than HUB_DEGREE edges, nearly all padded, and is the plan's
    only hub; the owner side has none."""
    from dgraph_tpu_torch.data import DistributedGraph, synthetic

    sbm = synthetic.sbm_classification_graph(num_nodes=2000, num_classes=5, feat_dim=8, seed=2)
    g = DistributedGraph.from_global(sbm["edge_index"], sbm["features"], sbm["labels"],
                                     sbm["masks"], world_size=1, partition_method="random")
    p = g.plan.shard(0)
    padded = p.e_pad - int(p.num_edges)
    assert padded == 384
    row_ptr = seg._row_ptr(p.halo_sorted_ids, p.n_src_pad + p.world_size * p.halo.s_pad)
    deg = (row_ptr[1:] - row_ptr[:-1]).numpy()
    assert deg[0] - padded <= deg[1:].max() <= 32 < seg.HUB_DEGREE < deg[0]
    hub = seg.hub_plan(row_ptr)
    assert hub.n_hubs == 1 and set(hub.chunks[0].tolist()) == {0}
    assert seg.hub_plan(seg._row_ptr(p.dst_index, p.n_dst_pad)) is None


def test_dropped_hub_chunk_leaves_out_one_chunk_of_kernel_1():
    """phase 12's control: inside ``dropped_hub_chunk`` kernel 1's CPU path
    leaves out the first chunk of the hub with the most chunks, and only
    that; outside it the plain version is back."""
    rng = np.random.default_rng(6)
    deg = np.array([3, seg.HUB_DEGREE + 1, 2 * seg.HUB_CHUNK + 5, 0, 4])
    ids = torch.from_numpy(np.repeat(np.arange(5), deg).astype(np.int32))
    data = _quarters(rng, len(ids), 4)
    bias = _quarters(rng, 5, 4)
    want = seg.sorted_segment_sum_bias_relu(data, ids, bias, 5)
    with chip_smoke.dropped_hub_chunk() as dropped:
        got = seg.sorted_segment_sum_bias_relu(data, ids, bias, 5)
    a = int(deg[:2].sum())
    lost = torch.relu(data[a:a + seg.HUB_CHUNK] + bias[2]).sum(0)
    assert dropped == {"row": 2, "chunk_edges": seg.HUB_CHUNK, "row_edges": int(deg[2])}
    assert torch.equal(got[[0, 1, 3, 4]], want[[0, 1, 3, 4]])
    assert torch.equal(got[2], want[2] - lost)
    assert torch.equal(seg.sorted_segment_sum_bias_relu(data, ids, bias, 5), want)
