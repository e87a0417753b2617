"""The port's nested-dict ("tree") helpers and every site that walks a
parameter tree: the engine's frozen lanes, the tolerance floor, the
float64 promotion, lane compaction's gather and scatter, and the carrying
of the JAX package's nested MultimodalCorrNMF parameters across
engine.transfer. Flat dicts must come through unchanged, so the stores of
the flat families keep their entry names."""

import numpy as np
import pytest
import torch

from salamander_tpu_torch.engine import (
    FitConfig,
    fit_loop_lockstep,
    params_from_numpy,
    params_to_numpy,
)
from salamander_tpu_torch.engine.fit import (
    _effective_tol,
    _masked_advance,
    init_lockstep_state,
)
from salamander_tpu_torch.engine.tree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from salamander_tpu_torch.models.signature_nmf import (
    cast_floating,
    promote_objective,
)
from salamander_tpu_torch.parallel import compaction, multistart

torch.set_num_threads(1)


def nested(n_lanes=4, dtype=torch.float64):
    gen = torch.Generator().manual_seed(0)

    def draw(*shape):
        return torch.rand((n_lanes,) + shape, generator=gen, dtype=dtype)

    return {
        "mods": {
            "sbs": {"signatures": draw(3, 12), "exposures": draw(20, 3)},
            "indel": {"signatures": draw(2, 9), "exposures": draw(20, 2)},
        },
        "sample_embeddings": draw(20, 2),
        "variance": draw(),
    }


def test_map_leaves_flatten_roundtrip():
    tree = nested()
    paths = list(tree_flatten(tree))
    assert paths == ["mods/sbs/signatures", "mods/sbs/exposures",
                     "mods/indel/signatures", "mods/indel/exposures",
                     "sample_embeddings", "variance"]
    assert [leaf.shape for leaf in tree_leaves(tree)] == \
        [leaf.shape for leaf in tree_flatten(tree).values()]
    rebuilt = tree_unflatten(tree_flatten(tree))
    assert list(rebuilt) == list(tree) and list(rebuilt["mods"]) == \
        ["sbs", "indel"]
    doubled = tree_map(lambda a, b: a + b, tree, tree)
    assert torch.equal(doubled["mods"]["indel"]["exposures"],
                       2 * tree["mods"]["indel"]["exposures"])
    with pytest.raises(ValueError, match="must not contain"):
        tree_flatten({"a/b": torch.zeros(1)})


def test_flat_dicts_are_their_own_flattening():
    flat = {"W": torch.zeros(2, 3), "H": torch.ones(3, 4)}
    assert list(tree_flatten(flat)) == ["W", "H"]
    assert tree_flatten(flat)["H"] is flat["H"]
    assert tree_unflatten(tree_flatten(flat)).keys() == flat.keys()
    assert tree_leaves(flat)[0] is flat["W"]


def test_transfer_carries_nested_trees_both_ways():
    host = params_to_numpy(nested())
    assert isinstance(host["mods"]["sbs"]["signatures"], np.ndarray)
    back = params_from_numpy(host, device="cpu", dtype=torch.float32)
    assert back["mods"]["indel"]["exposures"].dtype == torch.float32
    np.testing.assert_allclose(
        back["variance"].numpy(), host["variance"].astype(np.float32))
    flat = params_from_numpy({"W": np.ones((2, 3))}, device="cpu")
    assert list(flat) == ["W"] and flat["W"].dtype == torch.float64


def test_masked_advance_freezes_every_leaf():
    """A frozen lane keeps every leaf, nested ones included."""
    tree = nested()
    frozen = torch.tensor([True, False, True, False])
    out = _masked_advance(
        lambda params, n: tree_map(lambda leaf: leaf + n, params), tree,
        frozen, 3)
    for old, new in zip(tree_leaves(tree), tree_leaves(out)):
        assert torch.equal(new[frozen], old[frozen])
        assert torch.equal(new[~frozen], old[~frozen] + 3)


def test_tolerance_floor_and_promotion_see_nested_leaves():
    config = FitConfig(tol=1e-9)
    assert _effective_tol(config, torch.float64, nested(), warn=False) == 1e-9
    mixed = nested()
    mixed["mods"]["indel"]["exposures"] = \
        mixed["mods"]["indel"]["exposures"].float()
    floor = 10 * float(torch.finfo(torch.float32).eps)
    assert _effective_tol(config, torch.float64, mixed, warn=False) == floor

    def objective(params, data):
        return params["mods"]["indel"]["exposures"].sum() + data["X"]["a"].sum()

    data = {"X": {"a": torch.ones(3, dtype=torch.float32)}}
    assert promote_objective(objective, nested()) is objective
    promoted = promote_objective(objective, mixed)
    assert promoted(mixed, data).dtype == torch.float64
    cast = cast_floating({"a": {"b": torch.ones(2), "i": torch.arange(2)}},
                         torch.float64)
    assert cast["a"]["b"].dtype == torch.float64
    assert cast["a"]["i"].dtype == torch.int64


def _toy_problem(batched_data):
    """Lanes decay at their own rates, so they converge blocks apart; the
    data carries the lane axis only where every lane has its own."""
    rates = torch.tensor([0.5, 0.9, 0.7, 0.97, 0.6, 0.93, 0.8, 0.95],
                         dtype=torch.float64)
    params0 = {
        "mods": {"a": {"x": torch.ones(8, 3, dtype=torch.float64)},
                 "b": {"x": 2 * torch.ones(8, 2, 2, dtype=torch.float64)}},
        "rate": rates,
    }
    lanes = 8 if batched_data else 1
    data = {"X": {"a": torch.arange(lanes, dtype=torch.float64).view(-1, 1),
                  "b": torch.ones(lanes, 1, 1, dtype=torch.float64)}}

    def update_fn(params, data_):
        rate = params["rate"]
        return {
            "mods": {
                "a": {"x": params["mods"]["a"]["x"] * rate.view(-1, 1)},
                "b": {"x": params["mods"]["b"]["x"] * rate.view(-1, 1, 1)
                      * data_["X"]["b"]},
            },
            "rate": rate,
        }

    def objective_fn(params, data_):
        return (1.0 + params["mods"]["a"]["x"].sum(-1)
                + params["mods"]["b"]["x"].sum((-2, -1))
                + 0.0 * data_["X"]["a"].sum(-1))

    return params0, data, update_fn, objective_fn


@pytest.mark.parametrize("batched_data", [False, True])
def test_compaction_gathers_and_scatters_nested_trees(batched_data):
    params0, data, update_fn, objective_fn = _toy_problem(batched_data)
    config = FitConfig(min_iterations=2, max_iterations=400,
                       conv_test_freq=2, tol=1e-6)
    make_block = compaction.plain_block_builder(update_fn)
    mono, mono_losses = compaction.lockstep_fit(objective_fn, config,
                                                make_block, params0, data)
    runner = compaction.CompactingRunner(config, objective_fn, make_block,
                                         min_bucket=2,
                                         batched_data=batched_data)
    packed, packed_losses = runner.run(params0, data)
    assert len(set(mono.n_iterations.tolist())) > 3
    assert torch.equal(mono.n_iterations, packed.n_iterations)
    assert torch.equal(mono_losses, packed_losses)
    for a, b in zip(tree_leaves(mono.params), tree_leaves(packed.params)):
        assert torch.equal(a, b)
    state = init_lockstep_state(lambda p: objective_fn(p, data), params0,
                                config)
    taken = compaction._take_lanes(state, torch.tensor([1, 5]))
    assert taken.params["mods"]["b"]["x"].shape == (2, 2, 2)
    single = fit_loop_lockstep(lambda p: objective_fn(p, data), params0,
                               config, make_block(params0, data))
    assert torch.equal(single.n_iterations, mono.n_iterations)


def test_store_entries_keep_flat_names_and_nest_by_path():
    """A flat family's entry names are "p_" + key as before; a nested
    tree's are "p_" + path, and both come back in their own shape."""
    from salamander_tpu_torch.engine import FitResult

    def result_of(params):
        n = tree_leaves(params)[0].shape[0]
        return FitResult(params, torch.zeros(n), torch.zeros(n, 2),
                         torch.zeros(n, dtype=torch.int32),
                         torch.zeros(n, dtype=torch.int32))

    flat = {"W": torch.rand(4, 5, 2), "H": torch.rand(4, 2, 6)}
    entry = multistart._result_to_entry(result_of(flat), torch.zeros(4))
    assert {"p_W", "p_H"} <= set(entry)
    back, _ = multistart._entry_to_result(entry, "cpu")
    assert list(back.params) == ["W", "H"]
    assert torch.equal(back.params["W"], flat["W"])

    tree = nested()
    entry = multistart._result_to_entry(result_of(tree), torch.zeros(4))
    assert "p_mods/sbs/signatures" in entry and "p_variance" in entry
    back, _ = multistart._entry_to_result(entry, "cpu")
    assert torch.equal(back.params["mods"]["indel"]["exposures"],
                       tree["mods"]["indel"]["exposures"])
    joined, _ = multistart._concat_results(
        [(result_of(tree), torch.zeros(4)), (result_of(tree), torch.ones(4))])
    assert joined.params["mods"]["sbs"]["signatures"].shape == (8, 3, 12)
