"""The readings a cell's limits are set from (not run by the benchmark).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out file.jsonl]

For each seed, the program's jobs of that seed (as many as a run's check
compares) against the plain reference: the lower readings. For each
control seed, the reference computed in the precision below the
configuration's (float32 with TF32 products) in the program's place: the
upper readings. One JSON line per seed and side, then the largest program
reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import manifest, window  # noqa: E402
from portbench.reference.klnmf import TF32  # noqa: E402


def readings(cell_name: str, seeds, control_seeds, device="cuda",
             root: Path = ROOT, out=None, arith=TF32):
    """[(side, seed, {number: value})] for the program on `seeds` and the
    control on `control_seeds`."""
    import torch

    book = manifest.load(root)
    cell = manifest.cell(book, cell_name)
    config = manifest.config(book, cell, root)
    traffic = manifest.traffic(cell, root)
    kind = manifest.job_kind(traffic["entry"])
    device = torch.device(device)
    rows = []
    warm = None
    for side, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            state = kind.prepare(config, traffic, seed, device)
            if warm is None and side == "program":
                kind.warm(state)
                warm = True
            records = []
            for index in range(int(traffic["check_jobs"])):
                job_seed = window.job_seed(seed, index)
                start = time.perf_counter()
                record = (kind.job(state, job_seed) if side == "program"
                          else {})
                record.update(seed=job_seed, failed=False,
                              wall_s=time.perf_counter() - start)
                records.append(record)
            start = time.perf_counter()
            if side == "program":
                numbers = kind.check(state, records, seed)
            else:
                numbers = kind.check(state, records, seed, arith=arith,
                                     program=False)
            row = {"side": side, "seed": seed, "numbers": dict(numbers),
                   "job_s": [r["wall_s"] for r in records],
                   "check_s": time.perf_counter() - start}
            print(json.dumps(row), flush=True)
            if out is not None:
                with open(out, "a") as handle:
                    handle.write(json.dumps(row) + "\n")
            rows.append(row)
    return rows


def extremes(rows) -> dict:
    """Per number: the largest program reading, the smallest control
    reading."""
    out: dict = {}
    for row in rows:
        for name, value in row["numbers"].items():
            entry = out.setdefault(name, {"program_max": None,
                                          "control_min": None})
            key, pick = (("program_max", max) if row["side"] == "program"
                         else ("control_min", min))
            entry[key] = value if entry[key] is None else pick(entry[key],
                                                               value)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    def parse(text):
        return [int(s) for s in text.split(",") if s]

    rows = readings(args.workload, parse(args.seeds),
                    parse(args.control_seeds), out=args.out)
    print(json.dumps({"workload": args.workload,
                      "extremes": extremes(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
