"""kernel_wide_newton_share: the share of the CorrNMF Newton solves of
rows with more than OTHERS_MAX others (the signature side's samples) that
the wide kernel ran, read from the program's counters; None where the
program keeps no record or counts no wide solve (the parent of the
kernel's change counts none), and read in a tiny traced run of the
multimodal cell on the CPU with more samples than OTHERS_MAX (0 there:
the kernel route needs a card)."""

import json

import pytest

from portbench import manifest
from portbench.tests.test_portbench_mm_best_of import (  # noqa: F401
    MM,
    mm_root,
    run_tiny,
)

NAME = "kernel_wide_newton_share.mm_cohort"


def read(ctx):
    return manifest.reader(NAME).read(ctx)


def calls_counting(counts):
    return [{"id": i, "name": "multistart.fit_best_of", "spans": [],
             "counts": c} for i, c in enumerate(counts)]


@pytest.mark.parametrize("counts, share", [
    ([{"corrnmf.newton_solves_wide": 200,
       "corrnmf.newton_solves_wide_in_kernel": 200}], 100.0),
    ([{"corrnmf.newton_solves_wide": 30,
       "corrnmf.newton_solves_wide_in_kernel": 10},
      {"corrnmf.newton_solves_wide": 10}], 25.0),
    ([{"corrnmf.newton_solves.sample": 100,
       "corrnmf.newton_solves_in_kernel": 100}],
     None),  # a program that counts no wide solve
])
def test_share_of_a_hand_made_record(counts, share, monkeypatch):
    from salamander_tpu_torch import profiling

    monkeypatch.setattr(profiling, "calls",
                        lambda n: calls_counting(counts)[-n:])
    assert read({"traced": [{}] * len(counts)}) == share


def test_no_record_reads_none(monkeypatch):
    from salamander_tpu_torch import profiling

    assert read({"traced": None}) is None
    monkeypatch.delattr(profiling, "calls")
    assert read({"traced": [{}]}) is None


def test_entry_names_the_multimodal_cell():
    book = manifest.load()
    (entry,) = [metric for metric in manifest.metrics(
        book, manifest.cell(book, MM), "per_layer") if metric["name"] == NAME]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"],
            entry["moves"]) == ("%", "higher", "program_counter",
                                "plain ops", "lane_its_per_s")


def test_tiny_traced_run_reads_the_share(mm_root):  # noqa: F811
    """300 samples, above OTHERS_MAX: the signature side's solves are wide
    and run the plain steps on the CPU."""
    path = mm_root / "portbench" / "configs" / "pancancer_sbs_id_20k.json"
    config = json.loads(path.read_text())
    config["cohort"]["n_samples"] = 300
    path.write_text(json.dumps(config))
    result = run_tiny(mm_root, MM, trace=True)
    assert result["correct"] is True, result["check"]
    assert result["metrics"][NAME]["value"] == 0.0  # the CPU's plain route
