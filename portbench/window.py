"""The measured window: a closed loop of whole jobs, and its statistics.

One caller runs jobs back to back. A job starts only while the window is
open; the window runs from the first job's start to the last job's end,
every job ending with its results on the host. A job that raises counts
as failed and is not retried.
"""

from __future__ import annotations

import hashlib
import time
import traceback


def job_seed(seed: int, index: int) -> int:
    """The seed of job `index` of a run started with `seed`: the same for
    the parent and the change, below 2**31 for every consumer."""
    digest = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def closed_loop(run_job, seed: int, seconds: float, clock=time.perf_counter):
    """Run jobs run_job(job_seed) -> record (a dict) back to back while
    fewer than `seconds` have passed since the first job's start. Returns
    (records, window seconds); each record gains index, seed, start, end,
    wall_s and failed."""
    records = []
    opened = None
    index = 0
    while opened is None or clock() - opened < seconds:
        seed_i = job_seed(seed, index)
        start = clock()
        if opened is None:
            opened = start
        try:
            record = run_job(seed_i)
            failed = False
        except Exception:  # a failed job is counted, never retried
            traceback.print_exc()
            record, failed = {}, True
        end = clock()
        record.update(index=index, seed=seed_i, start=start, end=end,
                      wall_s=end - start, failed=failed)
        records.append(record)
        index += 1
    return records, records[-1]["end"] - opened
