"""The ICP loop's chunk as a CUDA graph (``icp_tpu_torch/icp/chunk_graph.py``)
on the CPU, at a tiny size (1024 landmarks, 16 representatives).

CPU tensors run the chunk eagerly: a registration counts eager chunks and
neither captures nor replays, and gives the bits of the chunked loop written
out. The decision to capture follows the device and the step path alone; the
cache's key tells apart configurations, lane counts, tensor shapes, strides
and dtypes, and not tensor values; the cache holds MAX_GRAPHS keys and
evicts the least recently used. The tree helpers keep the loop's containers
and every tensor's layout. The card's tests (``tests/test_torch_gpu.py``)
hold the replays bitwise to the eager loop.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import dataclasses

import pytest
import torch

import icp_tpu_torch
from icp_tpu_torch import (Correspondence, ICPConfig, ICPParams, Objective, RotationMode,
                           icp_step)
from icp_tpu_torch.icp import chunk_graph, run
from icp_tpu_torch.icp.state import ICPState, identity_state
from icp_tpu_torch.runtime.timing import counters
from icp_tpu_torch.sensors.synthetic import synthetic_pair

M = 1024
GRAPH_COUNTERS = ("icp.chunk_graph.captures", "icp.chunk_graph.replays", "icp.chunk_eager")
CUDA = torch.device("cuda", 0)  # a device object only: nothing runs on it here


def _pair(seed=3, m=M):
    return tuple(torch.from_numpy(a) for a in synthetic_pair(m, seed=seed))


def _counters():
    c = counters()
    return {name: c.get(name, 0) for name in GRAPH_COUNTERS + ("icp.steps_enqueued",)}


@pytest.mark.parametrize("entry", ["register", "register_batch"])
def test_cpu_loop_runs_every_chunk_eagerly(entry):
    config, params = ICPConfig(m=M, n_r=16), ICPParams(alpha=2e2)
    fixed, moving = _pair()
    before = _counters()
    if entry == "register":
        lanes = 1
        icp_tpu_torch.register(fixed, moving, params, config)
    else:
        lanes = 2
        icp_tpu_torch.register_batch(torch.stack([fixed, fixed]),
                                     torch.stack([moving, 0.5 * (moving + fixed)]),
                                     params, config)
    delta = {name: n - before[name] for name, n in _counters().items()}
    assert delta["icp.chunk_eager"] >= 1
    assert delta["icp.steps_enqueued"] == run.CHUNK * lanes * delta["icp.chunk_eager"]
    assert delta["icp.chunk_graph.captures"] == delta["icp.chunk_graph.replays"] == 0


@pytest.mark.parametrize("reads", [True, False])
def test_cpu_icp_run_equals_the_loop_written_out(reads):
    """icp_run against 8-step chunks of icp_step written out, with one read
    of the loop condition a chunk (or every chunk max_iterations allows):
    every field bitwise."""
    config = ICPConfig(m=M, n_r=16, max_iterations=12)
    params = ICPParams(alpha=2e2).to("cpu")
    fixed, moving = _pair()
    target = run.build_target(fixed, params, config)
    got = run.icp_run(moving, target, params, config, reads=reads)

    def running(state, done):
        return torch.logical_and(state.k < config.max_iterations,
                                 torch.logical_or(state.k == 0, torch.logical_not(done)))

    state = identity_state(torch.float32, "cpu")
    done = torch.zeros((), dtype=torch.bool)
    chunks = -(-config.max_iterations // run.CHUNK)
    while (bool(running(state, done)) if reads else chunks > 0):
        chunks -= 1
        for _ in range(run.CHUNK):
            take = running(state, done)
            new = icp_step(state, moving, target, params, config)
            state = run._select(take, new, state)
            done = torch.where(take, run.converged(new, params), done)
    for f in dataclasses.fields(ICPState):
        assert torch.equal(getattr(got, f.name), getattr(state, f.name)), f.name


@pytest.mark.parametrize("device, config, captured", [
    (torch.device("cpu"), ICPConfig(), False),
    (CUDA, ICPConfig(), True),
    (CUDA, ICPConfig(rotation=RotationMode.SVD), False),
    (CUDA, ICPConfig(rotation=RotationMode.JACOBI), False),
    (CUDA, ICPConfig(correspondence=Correspondence.BRUTE), True),
    (CUDA, ICPConfig(fused_point=False), True),
    (CUDA, ICPConfig(objective=Objective.PLANE, normal_mode="knn"), True),
    (CUDA, ICPConfig(objective=Objective.PLANE, rotation=RotationMode.SVD), True),
    (CUDA, ICPConfig(objective=Objective.GICP, rotation=RotationMode.JACOBI), True),
], ids=["cpu", "point", "svd", "jacobi", "brute", "unfused", "plane_knn",
        "plane_svd_unused", "gicp_jacobi_unused"])
def test_chunk_captured_follows_device_and_step_path(device, config, captured):
    """Captured on CUDA but where a POINT step solves its rotation with
    EAGER_ROTATIONS; PLANE and GICP solve no rotation, so their rotation
    field does not matter."""
    assert run.chunk_captured(device, config) is captured
    assert run.EAGER_ROTATIONS == {RotationMode.SVD, RotationMode.JACOBI}


def _loop_inputs(m=M, lanes=1, config=None, dtype=torch.float32):
    """(inputs, carry, config) as _run_lanes builds them, on the CPU."""
    config = config or ICPConfig(m=m, n_r=16)
    params = ICPParams(alpha=2e2).to("cpu")
    fixed, moving = _pair(m=m)
    fixed, moving = fixed.to(dtype), moving.to(dtype)
    target = run.build_target(fixed, params, config)
    inputs = run._Inputs([moving] * lanes, [target] * lanes, params, [None] * lanes)
    carry = run._carry([identity_state(dtype, "cpu")] * lanes,
                       [torch.zeros((), dtype=torch.bool)] * lanes, config)
    return inputs, carry, config


def _key(inputs, carry, config):
    return run.chunk_key(inputs, carry, config)


@pytest.mark.parametrize("change", ["config", "lanes", "shape", "stride", "dtype", "none"])
def test_chunk_key_tells_apart_what_a_capture_depends_on(change):
    inputs, carry, config = _loop_inputs()
    key = _key(inputs, carry, config)
    assert hash(key) == hash(_key(inputs, carry, config))
    if change == "config":
        other = _key(inputs, carry, dataclasses.replace(config, max_iterations=20))
    elif change == "lanes":
        other = _key(*_loop_inputs(lanes=2))
    elif change == "shape":
        other = _key(*_loop_inputs(m=512))
    elif change == "stride":
        wide = torch.zeros(M, 16)
        wide[:, :8] = inputs.movings[0]
        strided = inputs._replace(movings=[wide[:, :8]])
        assert torch.equal(strided.movings[0], inputs.movings[0])
        other = _key(strided, carry, config)
    elif change == "dtype":
        params64 = ICPParams(**{f.name: getattr(inputs.params, f.name).double()
                                for f in dataclasses.fields(ICPParams)})
        other = _key(inputs._replace(params=params64), carry, config)
    else:  # other values, the same layout: the same key
        moved = inputs._replace(movings=[inputs.movings[0] + 1.0],
                                params=ICPParams(alpha=1e2).to("cpu"))
        assert _key(moved, carry, config) == key
        return
    assert other != key


def test_tree_helpers_keep_containers_and_layouts():
    inputs, carry, _ = _loop_inputs()
    index = inputs.targets[0]
    assert isinstance(index, icp_tpu_torch.rbc.RBCIndex)
    # The graph's buffers: each tensor's shape, strides and dtype.
    copied = chunk_graph.tree_map(lambda t: chunk_graph._static(t).copy_(t), inputs)
    assert type(copied) is run._Inputs and type(copied.targets[0]) is type(index)
    assert type(copied.targets[0].layout) is type(index.layout)
    assert type(copied.params) is ICPParams and copied.mnormals == [None]
    got, want = chunk_graph.leaves(copied), chunk_graph.leaves(inputs)
    assert len(got) == len(want) > 20
    assert all(g is not w and torch.equal(g, w) for g, w in zip(got, want))
    assert chunk_graph.signature(copied) == chunk_graph.signature(inputs)
    # The grouped rows are strided views of one table; their buffers keep
    # the strides, so the kernels see the layout they saw eagerly.
    grouped = index.layout.grouped[0]
    assert not grouped.is_contiguous()
    assert copied.targets[0].layout.grouped[0].stride() == grouped.stride()
    states = chunk_graph.tree_map(torch.clone, carry)
    assert type(states) is run._Carry and type(states.states[0]) is ICPState


class _FakeGraph:
    """Stands in for ChunkGraph: records what it was given."""

    def __init__(self, body, inputs, carry):
        self.loaded = [(inputs, carry)]

    def load(self, inputs, carry):
        self.loaded.append((inputs, carry))


def test_cache_holds_max_graphs_and_evicts_least_recently_used(monkeypatch):
    monkeypatch.setattr(chunk_graph, "ChunkGraph", _FakeGraph)
    monkeypatch.setattr(chunk_graph, "_graphs", type(chunk_graph._graphs)())
    before = counters().get("icp.chunk_graph.captures", 0)
    n = chunk_graph.MAX_GRAPHS
    graphs = [chunk_graph.chunk_graph(("key", i), None, i, i) for i in range(n)]
    again = chunk_graph.chunk_graph(("key", 0), None, "in", "carry")  # a hit
    assert again is graphs[0] and again.loaded == [(0, 0), ("in", "carry")]
    chunk_graph.chunk_graph(("key", n), None, n, n)  # evicts key 1, the least recent
    assert list(chunk_graph._graphs) == [("key", i) for i in [*range(2, n), 0, n]]
    assert counters()["icp.chunk_graph.captures"] - before == n + 1
    chunk_graph.clear()
    assert not chunk_graph._graphs
