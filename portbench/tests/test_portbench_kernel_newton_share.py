"""kernel_newton_share: the share of the unrolled CorrNMF Newton solves
that the kernel ran, read from the program's counters; None where the
program keeps no record or counts no unrolled solve (the parent of the
kernel's change counts none), and read in a tiny traced run of the
multimodal cell on the CPU (0 there: the kernel route needs a card)."""

import pytest

from portbench import manifest
from portbench.tests.test_portbench_mm_best_of import (  # noqa: F401
    MM,
    mm_root,
    run_tiny,
)

NAME = "kernel_newton_share.mm_cohort"


def read(ctx):
    return manifest.reader(NAME).read(ctx)


def calls_counting(counts):
    return [{"id": i, "name": "multistart.fit_best_of", "spans": [],
             "counts": c} for i, c in enumerate(counts)]


@pytest.mark.parametrize("counts, share", [
    ([{"corrnmf.newton_solves.sample": 100,
       "corrnmf.newton_solves_in_kernel": 100}], 100.0),
    ([{"corrnmf.newton_solves.sample": 30,
       "corrnmf.newton_solves.signature": 10,
       "corrnmf.newton_solves_in_kernel": 10}], 25.0),
    ([{"corrnmf.newton_steps.sample": 300, "mmcorrnmf.cycles": 100}],
     None),  # a program that counts no solve
])
def test_share_of_a_hand_made_record(counts, share, monkeypatch):
    from salamander_tpu_torch import profiling

    monkeypatch.setattr(profiling, "calls",
                        lambda n: calls_counting(counts)[-n:])
    assert read({"traced": [{}]}) == share


def test_no_record_reads_none(monkeypatch):
    from salamander_tpu_torch import profiling

    assert read({"traced": None}) is None
    monkeypatch.delattr(profiling, "calls")
    assert read({"traced": [{}]}) is None


def test_entry_names_the_multimodal_cell():
    book = manifest.load()
    names = {metric["name"] for metric in manifest.metrics(
        book, manifest.cell(book, MM), "per_layer")}
    assert NAME in names


def test_tiny_traced_run_reads_the_share(mm_root):  # noqa: F811
    result = run_tiny(mm_root, MM, trace=True)
    assert result["correct"] is True, result["check"]
    assert result["metrics"][NAME]["value"] == 0.0  # the CPU's plain route
