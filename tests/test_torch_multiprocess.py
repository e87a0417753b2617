"""A real two-process torch.distributed rendezvous, mirroring
tests/test_multiprocess.py.

The test starts this file twice as a script (the worker below, under
``if __name__ == "__main__"``): each process brings up
salamander_tpu_torch.parallel.init_distributed(coordinator_address=
"127.0.0.1:<free port>", num_processes=2, process_id=i) over gloo, builds
a (2, 1) mesh whose restart axis crosses the two processes, and runs the
batched multi-start KLNMF fit there; process 0 writes the gathered result.
It must equal the single-process fit of the same seed. Both workers are
killed if they outlast the time limit. The worker imports neither jax nor
the JAX package."""

import os
import socket
import subprocess
import sys

import numpy as np

N_FEATURES, N_SAMPLES, RANK, N_RESTARTS, SEED = 12, 16, 3, 4, 7
TIMEOUT = 120


def inputs():
    rng = np.random.default_rng(123)
    X = rng.poisson(5.0, size=(N_FEATURES, N_SAMPLES)).astype(np.float64)
    X[X == 0] = 1.0
    return X


def fit(mesh=None):
    import torch

    import salamander_tpu_torch as port

    config = port.FitConfig(min_iterations=40, max_iterations=40,
                            conv_test_freq=10)
    return port.fit_klnmf_restarts(inputs(), RANK, N_RESTARTS, seed=SEED,
                                   config=config, mesh=mesh,
                                   dtype=torch.float64, device="cpu")


def worker(process_id: int, num_processes: int, port_number: int,
           out_path: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    import salamander_tpu_torch as port

    torch.set_num_threads(1)
    port.init_distributed(coordinator_address=f"127.0.0.1:{port_number}",
                          num_processes=num_processes, process_id=process_id,
                          device="cpu",
                          timeout=datetime.timedelta(seconds=60))
    assert dist.get_world_size() == num_processes
    mesh = port.make_mesh(sample_ways=1, device="cpu")
    assert tuple(mesh.shape) == (num_processes, 1)
    result = fit(mesh)
    if process_id == 0:
        np.savez(out_path, losses=result.losses,
                 n_iterations=result.n_iterations, W=np.asarray(result.W),
                 best_W=np.asarray(result.best_W),
                 n_processes=dist.get_world_size())
    dist.destroy_process_group()
    print(f"worker {process_id}: OK", flush=True)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_workers(out_path) -> None:
    port_number = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    workers = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid), "2",
             str(port_number), str(out_path)],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outputs = []
    try:
        for process in workers:
            outputs.append(process.communicate(timeout=TIMEOUT)[0])
    finally:
        for process in workers:
            if process.poll() is None:
                process.kill()
                process.communicate()
    for process, out in zip(workers, outputs):
        assert process.returncode == 0, f"{process.args}:\n{out[-4000:]}"


def test_cross_process_restart_fit_matches_single_process(tmp_path):
    out_path = tmp_path / "result.npz"
    run_workers(out_path)
    got = np.load(out_path)
    assert int(got["n_processes"]) == 2
    single = fit()
    np.testing.assert_array_equal(got["n_iterations"], single.n_iterations)
    # each process runs its lanes as the single process does: bit-equal
    np.testing.assert_array_equal(got["losses"], single.losses)
    np.testing.assert_array_equal(got["W"], np.asarray(single.W))
    np.testing.assert_array_equal(got["best_W"], np.asarray(single.best_W))


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
