"""The control, at a size a test run holds: the reference computed in the
precision below the configuration's (float32 with TF32 products) in the
program's place fails a limit of the cell, where the program passes them
all. On a card the same readings at the cells' own sizes set the limits
(portbench/calibrate.py; PERF.md)."""

import json

import pytest

from portbench import calibrate

CELLS = ["pcawg_sbs-restarts100", "pcawg_sbs-extract",
         "pancancer_sbs_20k-extract", "pancancer_sbs_20k-assign"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(tiny_root, cell):
    limits = json.loads((tiny_root / "portbench" / "limits"
                         / f"{cell}.json").read_text())["limits"]
    rows = calibrate.readings(cell, [2**31 + 1], [2**31 + 2], device="cpu",
                              root=tiny_root)
    program, control = rows[0]["numbers"], rows[1]["numbers"]
    assert all(program[name] <= limits[name] for name in limits), program
    assert any(control[name] > limits[name] for name in limits), control
