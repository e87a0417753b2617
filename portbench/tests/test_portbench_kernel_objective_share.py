"""kernel_objective_share: the share of the engine's blocks whose
objective came from the kernel launch, read from the program's counters;
None where the program keeps no record or counts no block, and read in a
tiny traced run of each KLNMF cell on the CPU (0 there: the kernel route
needs a card)."""

import pytest

from portbench import manifest, run

SEED = 2**31 + 8765
CELLS = {"pcawg_sbs-restarts100": "restarts",
         "pcawg_sbs-extract": "pcawg_extract",
         "pancancer_sbs_20k-extract": "cohort_extract"}


def read(name, ctx):
    return manifest.reader(name).read(ctx)


def calls_counting(counts):
    return [{"id": i, "name": "restarts.fit", "spans": [], "counts": c}
            for i, c in enumerate(counts)]


@pytest.mark.parametrize("counts, share", [
    ([{"engine.block_evals": 40, "engine.block_evals_in_kernel": 40},
      {"engine.block_evals": 60, "engine.block_evals_in_kernel": 60}], 100.0),
    ([{"engine.block_evals": 40, "engine.block_evals_in_kernel": 10},
      {"engine.block_evals": 60}], 10.0),
    ([{"engine.lane_steps": 10}, {}], None),  # a program that counts none
])
def test_share_of_a_hand_made_record(counts, share, monkeypatch):
    from salamander_tpu_torch import profiling

    monkeypatch.setattr(profiling, "calls",
                        lambda n: calls_counting(counts)[-n:])
    ctx = {"traced": [{}, {}]}
    for suffix in CELLS.values():
        assert read(f"kernel_objective_share.{suffix}", ctx) == share


def test_no_record_reads_none(monkeypatch):
    from salamander_tpu_torch import profiling

    assert read("kernel_objective_share.restarts", {"traced": None}) is None
    monkeypatch.delattr(profiling, "calls")
    assert read("kernel_objective_share.restarts",
                {"traced": [{}]}) is None


def test_entries_name_the_klnmf_cells():
    book = manifest.load()
    for cell, suffix in CELLS.items():
        names = {metric["name"] for metric in manifest.metrics(
            book, manifest.cell(book, cell), "per_layer")}
        assert f"kernel_objective_share.{suffix}" in names


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_the_share(tiny_root, cell):
    result = run.run_cell(cell, SEED, 0.5, True, device="cpu",
                          root=tiny_root)
    assert result["correct"] is True, result["check"]
    value = result["metrics"][f"kernel_objective_share.{CELLS[cell]}"][
        "value"]
    assert value == 0.0  # the CPU runs the plain route
