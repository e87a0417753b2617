"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the CUDA context, the kernel library, the inputs from
the seed, one small warm-up job) is timed from the start of this script.
Then a closed loop of whole jobs runs for --seconds; with --trace 1 the
first jobs' seeds run again under torch.profiler. Once the window has
closed and the peak memory is read, sampled outputs are compared with the
plain reference (portbench/reference), each number beside its limit
(portbench/limits/<cell>.json). The last line of standard output is the
result, one JSON object.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import importcheck, manifest, window  # noqa: E402
from portbench import trace as tracing  # noqa: E402
from portbench.entries import program_counters  # noqa: E402


def limits(cell: str, root: Path = ROOT) -> dict:
    with open(Path(root) / "portbench" / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _profile(kind, state, records, device):
    """The records' seeds again, each job under torch.profiler inside a
    benchmark span: the profile's summary, one entry a job with its
    untraced record beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = program_counters()["launches"]
    with profile(activities=activities) as prof:
        for record in records:
            with record_function(tracing.JOB_SPAN):
                kind.job(state, record["seed"])
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    launches = program_counters()["launches"] - before
    device_events, host_events = tracing.read_profile(prof)
    summary = tracing.summarize(device_events, host_events)
    kernels = sum(job["kernel_count"] for job in summary["jobs"])
    print(f"[portbench] traced {len(records)} jobs: {kernels} mu_block "
          f"kernels in the profile against {launches} launches counted by "
          f"the program; {len(device_events)} device events",
          file=sys.stderr)
    for job, record in zip(summary["jobs"], records):
        job["untraced"] = record
    return summary


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = ROOT, started: float = STARTED):
    """Run a cell; returns the result dict (the contract's keys, "check"
    last)."""
    import torch

    device = torch.device(device)
    warnings.filterwarnings("ignore", category=UserWarning,
                            module=r"salamander_tpu_torch(\..*)?")
    book = manifest.load(root)
    cell = manifest.cell(book, cell_name)
    config = manifest.config(book, cell, root)
    traffic = manifest.traffic(cell, root)
    bounds = limits(cell_name, root)
    kind = manifest.job_kind(traffic["entry"])
    cuda = device.type == "cuda"

    state = kind.prepare(config, traffic, seed, device)
    kind.warm(state)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def one(job_seed):
        record = kind.job(state, job_seed)
        if cuda:
            torch.cuda.synchronize(device)
        return record

    records, window_s = window.closed_loop(one, seed, seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    walls = sorted(record["wall_s"] for record in records)
    print(f"[portbench] set-up {setup_s:.3f} s; window {window_s:.3f} s, "
          f"{len(records)} jobs, walls {walls[0]:.4f} / "
          f"{walls[len(walls) // 2]:.4f} / {walls[-1]:.4f} s (least, "
          f"median, most); peak {memory_peak} bytes", file=sys.stderr)

    summary = None
    if trace:
        profiled = [r for r in records if not r["failed"]][
            :int(traffic["profiled_jobs"])]
        summary = _profile(kind, state, profiled, device)

    found = importcheck.forbidden_loaded()
    if found:
        raise SystemExit(f"[portbench] forbidden modules loaded: {found}")

    ctx = {"setup_s": setup_s, "window_s": window_s, "jobs": records,
           "traced": summary["jobs"] if summary else None}
    metrics = {}
    for metric in manifest.metrics(book, cell,
                                   "per_layer" if trace else "end_to_end"):
        value = manifest.reader(metric["name"], root).read(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}

    if cuda:
        torch.cuda.empty_cache()
    checked = time.perf_counter()
    try:
        numbers = kind.check(state, records, seed)
        error = None
    except Exception as exc:  # a check that cannot compare is a failure
        import traceback

        traceback.print_exc()
        numbers, error = [], f"{type(exc).__name__}: {exc}"
    print(f"[portbench] check {time.perf_counter() - checked:.3f} s",
          file=sys.stderr)
    compared = {name: {"value": value, "limit": bounds[name]}
                for name, value in numbers}
    correct = (error is None and bool(compared)
               and all(item["value"] <= item["limit"]
                       for item in compared.values())
               and any(not record["failed"] for record in records))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(device) if cuda
                    else "cpu"),
           "count": int(cell["chips"]) if cuda else 1,
           "memory_peak_bytes": int(memory_peak)}
    if cuda:
        dev["power_limit"] = power_limit()
    if summary is not None:
        dev["busy_s"] = sum(job["busy_s"] for job in summary["jobs"])
        dev["window_s"] = sum(job["wall_s"] for job in summary["jobs"])
    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": sum(record["failed"] for record in records),
        "metrics": metrics,
        "device": dev,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if error is not None:
        compared["check_error"] = {"value": error, "limit": "none"}
    result["check"] = compared
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    cell = manifest.cell(manifest.load(), args.workload)
    if not torch.cuda.is_available():
        print("[portbench] no CUDA device: nothing is measured",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"[portbench] {cell['chips']} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    for name, item in result["check"].items():
        print(f"[portbench] check {name}: {item['value']} "
              f"(limit {item['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
