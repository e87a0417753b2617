"""The JAX suite's cohort cells 7b (benchmarks/suite.py:950) and 8b
(:1044) as chip_smoke.py phases 20a and 20b run them, on the CPU without a
card: the layout, launch plan and chunks that cell 7b's shapes get under
the card's memory budget, the chunks of cell 8b's candidates, and cell
8b's cohort through the JAX package's and the port's assign_signatures at
float64 (supports equal, kl_sparse at rtol 1e-8, the suite's budget
contract)."""

import contextlib

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import salamander_tpu_torch as port
from salamander_tpu import assign as jax_assign
from salamander_tpu_torch import assign, extraction
from salamander_tpu_torch.ops import cuda_klnmf

torch.set_num_threads(1)

# chip_smoke.py phase 1 on the H100 (NVIDIA H100 80GB HBM3): 85.02 GB in
# all, of which assign._DEVICE_MEMORY_SHARE is the budget
CARD_TOTAL = 85.02e9
CARD_SMS = 132
V, D_7B, RANKS_7B, BOOTSTRAPS_7B = 96, 200_000, range(2, 11), 10
K_8B, D_8B = 79, 100_000


@pytest.fixture
def card_budget(monkeypatch):
    budget = int(assign._DEVICE_MEMORY_SHARE * CARD_TOTAL)
    monkeypatch.setattr(assign, "_memory_budget", lambda device: budget)
    return budget


def test_cell_7b_takes_the_grouped_layout():
    assert extraction._choose_layout("klnmf", torch.float32, 0, RANKS_7B,
                                     V, D_7B, "cuda") == "grouped"
    assert extraction._choose_layout("klnmf", torch.float32, 0, RANKS_7B,
                                     V, D_7B, "cpu") == "padded"


@pytest.mark.parametrize("k", list(RANKS_7B))
def test_cell_7b_rank_groups_plan_the_streamed_kernel(k):
    plan = cuda_klnmf.plan_launch(BOOTSTRAPS_7B, V, k, D_7B, CARD_SMS)
    assert plan.variant == "streamed"
    assert 1 < plan.cluster and BOOTSTRAPS_7B * plan.cluster <= CARD_SMS


# the peaks of cells 7b and 8b in chip_smoke.py phases 20a and 20b on an
# H100 (NVIDIA H100 80GB HBM3, 700.00 W)
PEAK_7B, PEAK_8B = 17.749e9, 16.404e9


def test_cell_7b_runs_as_one_chunk(card_budget):
    """90 lanes, 10 at a time: 18.13 GB reckoned, above the 17.75 GB the
    H100 run peaked at and under the budget; the closed form takes the
    most lanes whose reckoning fits."""
    n_lanes = len(RANKS_7B) * BOOTSTRAPS_7B
    reckoned = extraction._chunk_bytes(n_lanes, BOOTSTRAPS_7B, BOOTSTRAPS_7B,
                                       torch.float32, V, D_7B, 10)
    assert reckoned == pytest.approx(18.13e9, rel=1e-3)
    assert PEAK_7B < reckoned < card_budget
    assert extraction._lane_chunk_size(
        n_lanes, None, torch.float32, V, D_7B, 10, "cuda", BOOTSTRAPS_7B,
        batch_lanes=BOOTSTRAPS_7B) == n_lanes
    # the padded layout runs every lane of a chunk at once: three chunks
    assert extraction._lane_chunk_size(
        n_lanes, None, torch.float32, V, D_7B, 10, "cuda",
        BOOTSTRAPS_7B) == 30


@pytest.mark.parametrize("batch_lanes", [None, 1, 4, 10])
@pytest.mark.parametrize("gb", [0.05, 0.2, 1.0, 3.0, 20.0])
def test_lane_chunks_are_the_most_that_fit(batch_lanes, gb):
    """_lane_chunk_size's closed form against a search over every chunk
    size: the most lanes whose _chunk_bytes fit the budget (at least one),
    evened into equal chunks."""
    n_lanes, d, n_padded = 40, 20_000, 6
    budget = int(gb * 2**30)

    def reckoned(c):
        batch = c if batch_lanes is None else min(c, batch_lanes)
        return extraction._chunk_bytes(c, batch, 4, torch.float32, V, d,
                                       n_padded)

    fits = max([1] + [c for c in range(1, n_lanes + 1)
                      if reckoned(c) <= budget])
    n_chunks = -(-n_lanes // fits)
    assert extraction._lane_chunk_size(
        n_lanes, gb, torch.float32, V, d, n_padded, "cuda", 4,
        batch_lanes=batch_lanes) == -(n_lanes // -n_chunks)


def test_cell_8b_candidates_run_at_once(card_budget):
    """16.47 GB reckoned, above the 16.40 GB the H100 run peaked at."""
    per_sample = assign.candidate_bytes_per_sample(V, K_8B, 4)
    assert per_sample * D_8B == pytest.approx(16.47e9, rel=1e-3)
    assert PEAK_8B < per_sample * D_8B < card_budget
    assert assign._memory_lanes(torch.device("cuda"), per_sample,
                                D_8B) == D_8B


def test_cohort_8b_is_the_suites_cohort():
    data, cosmic, planted = chip_smoke.cohort_8b(50)
    assert data.shape == (50, V) and cosmic.shape == (K_8B, V)
    assert list(data.columns) == list(cosmic.columns)
    assert len(set(planted)) == 5
    X = data.to_numpy()
    assert X.dtype == np.float64 and (X >= 1).all()
    assert np.array_equal(X, np.round(X))
    again, _, planted_again = chip_smoke.cohort_8b(50)
    pd.testing.assert_frame_equal(data, again)
    assert np.array_equal(planted, planted_again)


def test_cohort_8b_assignment_matches_jax():
    """300 samples of cell 8b's cohort, float64 on the CPU, at the
    defaults phase 20b runs: equal supports, kl_sparse at rtol 1e-8, and
    the suite's budget assertion (no sample over 1.02 kl_dense by more
    than one float32 ulp) holds in both packages."""
    data, cosmic, planted = chip_smoke.cohort_8b(300)
    expected = jax_assign.assign_signatures(data, cosmic, rel_tol=0.02)
    actual = port.assign_signatures(data, cosmic, rel_tol=0.02,
                                    device="cpu")
    pd.testing.assert_frame_equal(actual.active, expected.active)
    np.testing.assert_allclose(actual.kl_sparse.to_numpy(),
                               expected.kl_sparse.to_numpy(), rtol=1e-8)
    np.testing.assert_allclose(actual.kl_dense.to_numpy(),
                               expected.kl_dense.to_numpy(), rtol=1e-8)
    for result in (actual, expected):
        assert chip_smoke.budget_excess(result).max() <= chip_smoke.BUDGET_ULP
    assert actual.meta["n_rounds"] == expected.meta["n_rounds"]
    support = actual.n_active.to_numpy()
    assert 5 <= support.min() and support.max() < K_8B
    assert actual.active.to_numpy()[:, planted].all(1).mean() > 0.5


class _Graph:
    """A CUDAGraph stand-in that records its calls in `events`."""
    count = 0
    events: list = []

    def __init__(self):
        _Graph.count += 1
        self.name = f"g{_Graph.count}"

    def capture_begin(self, pool=None):
        self.events.append(("capture", self.name, pool))

    def capture_end(self):
        self.events.append(("end", self.name))

    def pool(self):
        return f"pool of {self.name}"

    def replay(self):
        self.events.append(("replay", self.name))

    def reset(self):
        self.events.append(("reset", self.name))


@pytest.fixture
def fake_graphs(monkeypatch):
    """Span graphs captured through _Graph: returns (the engine's fit
    module, a function that runs one graphed segment, the events)."""
    from typing import NamedTuple

    from salamander_tpu_torch.engine import fit as engine_fit

    monkeypatch.setattr(_Graph, "count", 0)
    monkeypatch.setattr(_Graph, "events", [])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *a: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda *a: contextlib.nullcontext())
    monkeypatch.setattr(engine_fit, "_capture_stream", lambda index: None)
    handles = iter(range(1, 100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: f"new pool {next(handles)}")
    monkeypatch.setattr(engine_fit, "graph_counts",
                        {"captures": 0, "replays": 0})

    class State(NamedTuple):
        params: dict
        count: torch.Tensor

    def step(state):
        return State({"W": state.params["W"] * 2}, state.count + 1)

    def segment():  # one fit's spans, as one rank group runs
        spans = engine_fit._Spans(step, graphed=True)
        state = State({"W": torch.ones(3)}, torch.zeros(()))
        for _ in range(3):  # eager warm-up, capture and replay, replay
            state = spans.run(state, engine_fit.SPAN)
        spans.release()

    return engine_fit, segment, _Graph.events


def test_span_graphs_share_the_last_released_pool(fake_graphs):
    """The fault cell 7b exposed on the card: every span graph took a
    memory pool of its own, the pools of released graphs stayed cached,
    and the allocator cannot hand cached memory back while a capture
    runs, so a later rank group's capture ran out of memory. Within
    shared_span_pool() a released span graph is kept until the next
    capture on its card, which shares its pool and then resets it: two
    segments, each capturing once, capture into one pool; the first graph
    is reset after the second capture, the second when the scope ends,
    and nested scopes (a runner within an extraction chunk) end with the
    outermost. The card's side of it (reserved memory flat over captures
    and handed back after them) is
    tests/test_torch_cuda.py::test_span_graphs_reuse_one_memory_pool."""
    engine_fit, segment, events = fake_graphs
    with engine_fit.shared_span_pool():
        for _ in range(2):
            with engine_fit.shared_span_pool():
                segment()
        assert events[-1] == ("replay", "g2")
    assert events == [
        ("capture", "g1", "new pool 1"), ("end", "g1"),
        ("replay", "g1"), ("replay", "g1"),
        ("capture", "g2", "pool of g1"), ("end", "g2"), ("reset", "g1"),
        ("replay", "g2"), ("replay", "g2"), ("reset", "g2")]
    assert engine_fit._handoff is None


def test_span_graphs_outside_a_scope_reset_at_release(fake_graphs):
    """Outside shared_span_pool() a fit's span graph is reset when the fit
    releases it, and the next capture takes a pool of its own."""
    engine_fit, segment, events = fake_graphs
    segment()
    segment()
    assert events == [
        ("capture", "g1", "new pool 1"), ("end", "g1"),
        ("replay", "g1"), ("replay", "g1"), ("reset", "g1"),
        ("capture", "g2", "new pool 2"), ("end", "g2"),
        ("replay", "g2"), ("replay", "g2"), ("reset", "g2")]


@pytest.mark.parametrize("scoped", [False, True])
def test_a_failed_capture_ends_its_hold_on_the_pool(fake_graphs, monkeypatch,
                                                     scoped):
    """A capture that fails (its capture_end raises) leaves the allocator
    recording into the capture's pool unless the engine ends it: on an
    H100 the card could then free no cached memory for the rest of the
    process. The engine ends the recording and releases the capture's
    hold on the pool it passed to capture_begin, then raises; within a
    scope the graph it took the pool from is still reset."""
    engine_fit, segment, events = fake_graphs

    def fails():
        events.append(("end failed",))
        raise RuntimeError("operation failed due to a previous error "
                           "during capture")

    for name in ("_cuda_endAllocateToPool", "_cuda_releasePool"):
        monkeypatch.setattr(torch._C, name, lambda index, pool, name=name:
                            events.append((name, index, pool)))
    with engine_fit.shared_span_pool() if scoped else \
            contextlib.nullcontext():
        if scoped:
            segment()
        events.clear()
        monkeypatch.setattr(_Graph, "capture_end",
                            lambda self: fails())
        with pytest.raises(RuntimeError, match="during capture"):
            segment()
    pool = "pool of g1" if scoped else "new pool 1"
    index = None  # the device index of the fake's CPU state
    assert events[:4] == [
        ("capture", "g2" if scoped else "g1", pool), ("end failed",),
        ("_cuda_endAllocateToPool", index, pool),
        ("_cuda_releasePool", index, pool)]
    assert events[4:] == ([("reset", "g1")] if scoped else [])
