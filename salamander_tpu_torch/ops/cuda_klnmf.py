"""The fused KLNMF multiplicative-update block: the CUDA kernel of
csrc/mu_block.cu, its build and binding, and its plain PyTorch version.

Held against salamander_tpu/ops/pallas_klnmf.py::fused_mu_block, with a
leading restart axis: W (R, V, K) and H (R, K, D) advance by ``n_steps``
joint updates against one X (V, D). ``n_steps`` is a run-time argument, so
one binary serves the fit loop's full blocks and its remainder tail.

Build: nvcc compiles the source for sm_90a into a shared library with a
plain C interface, at first use, under ``build/`` at the root of the
checkout (named by a hash of the source, so an edited source builds anew),
and ``ctypes`` loads it. Nothing is built or imported when this module is
imported.

Routing is decided before a launch, never on failure:
:func:`mu_block_supported` says whether a fit's block update may run the
kernel. :func:`fused_mu_block` runs the plain version for tensors on the
CPU and launches the kernel for tensors on a card; a build or launch error
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .klnmf import update_WH

K_MAX = 32          # MU_BLOCK_K_MAX in csrc/mu_block.cu
_TILE_PITCH = 33    # MU_BLOCK_TILE_D + 1 in csrc/mu_block.cu
_SHARED_LIMIT = 232448  # bytes of shared memory a Hopper block may use

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mu_block.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"


def shared_bytes(n_features: int, n_signatures: int) -> int:
    """Dynamic shared memory of one block (mu_block_shared_bytes)."""
    return 4 * (2 * n_features * n_signatures
                + (n_features + n_signatures) * _TILE_PITCH)


def unsupported_reason(X, W, H, data=None, n_given_signatures: int = 0,
                       mask=None):
    """Why the kernel cannot run this block update, or None if it can.

    The kernel covers float32, unweighted, unpadded fits without given
    signatures, with K <= K_MAX and W in shared memory, on a card. Every
    other configuration runs the plain update (as the JAX package runs
    XLA); a rank `mask` marks a padded (rank-masked) fit.
    """
    data = {} if data is None else data
    if any(t.dtype != torch.float32 for t in (X, W, H)):
        return "the kernel is float32 only"
    if data.get("weights_kl") is not None or \
            data.get("weights_lhalf") is not None:
        return "the kernel has no loss weights"
    if n_given_signatures:
        return "the kernel has no given signatures"
    if mask is not None:
        return "the kernel has no rank mask"
    n_features, n_signatures = W.shape[-2], W.shape[-1]
    if n_signatures > K_MAX:
        return f"K={n_signatures} above K_MAX={K_MAX}"
    if shared_bytes(n_features, n_signatures) > _SHARED_LIMIT:
        return f"V={n_features}, K={n_signatures} exceed shared memory"
    if not all(t.is_cuda for t in (X, W, H)):
        return "the tensors are not on a CUDA device"
    return None


def mu_block_supported(X, W, H, data=None, n_given_signatures: int = 0,
                       mask=None):
    """Whether a fit's block update runs the kernel (see
    unsupported_reason)."""
    return unsupported_reason(X, W, H, data, n_given_signatures,
                              mask) is None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    found = shutil.which("nvcc") or (str(candidate) if candidate.exists()
                                     else None)
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/mu_block.cu")
    return found


def build() -> Path:
    """Compile csrc/mu_block.cu for sm_90a (once per source version) and
    return the shared library's path. ptxas's register and shared-memory
    report is kept beside it with the suffix '.log'."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    library = BUILD_DIR / f"mu_block-{digest}.so"
    if library.exists():
        return library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = library.with_name(f"{library.name}.{os.getpid()}.partial")
    command = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(partial), str(SOURCE),
    ]
    run = subprocess.run(command, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({run.returncode}):\n{run.stdout}{run.stderr}"
        )
    library.with_suffix(".log").write_text(run.stdout + run.stderr)
    os.replace(partial, library)  # atomic: concurrent builds agree
    return library


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()))
    lib.mu_block_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int
    ] * 5 + [ctypes.c_void_p]
    lib.mu_block_launch.restype = ctypes.c_int
    lib.mu_block_error_string.argtypes = [ctypes.c_int]
    lib.mu_block_error_string.restype = ctypes.c_char_p
    lib.mu_block_k_max.argtypes = []
    lib.mu_block_k_max.restype = ctypes.c_int
    lib.mu_block_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mu_block_shared_bytes.restype = ctypes.c_size_t
    if lib.mu_block_k_max() != K_MAX or \
            lib.mu_block_shared_bytes(96, 5) != shared_bytes(96, 5):
        raise RuntimeError("csrc/mu_block.cu and ops/cuda_klnmf.py disagree "
                           "on K_MAX or the shared-memory layout")
    return lib


def fused_mu_block_reference(X, W, H, n_steps: int):
    """Plain PyTorch version: n_steps joint updates (ops.klnmf.update_WH)
    of W (R, V, K) and H (R, K, D) against X (V, D)."""
    for _ in range(int(n_steps)):
        W, H = update_WH(X, W, H)
    return W, H


def _check_kernel_inputs(X, W, H):
    reason = unsupported_reason(X, W, H)
    if reason is not None:
        raise ValueError(f"fused_mu_block cannot launch: {reason}")
    if X.dim() != 2 or W.dim() != 3 or H.dim() != 3:
        raise ValueError("fused_mu_block takes X (V, D), W (R, V, K) and "
                         "H (R, K, D)")
    (V, D), (R, V_w, K) = X.shape, W.shape
    if V_w != V or tuple(H.shape) != (R, K, D):
        raise ValueError(f"shapes disagree: X {tuple(X.shape)}, W "
                         f"{tuple(W.shape)}, H {tuple(H.shape)}")
    if len({t.device for t in (X, W, H)}) != 1:
        raise ValueError("X, W and H must lie on one device")
    if not all(t.is_contiguous() for t in (X, W, H)):
        raise ValueError("fused_mu_block takes contiguous tensors")


def fused_mu_block(X, W, H, n_steps: int):
    """Advance W (R, V, K) and H (R, K, D) by n_steps joint multiplicative
    updates against X (V, D).

    CPU tensors run fused_mu_block_reference. CUDA tensors launch the
    kernel of csrc/mu_block.cu on the current stream (one thread block per
    lane), or raise if the kernel does not take them. Each launch adds one
    to ``fused_mu_block.launches``.
    """
    if all(t.device.type == "cpu" for t in (X, W, H)):
        return fused_mu_block_reference(X, W, H, n_steps)
    _check_kernel_inputs(X, W, H)
    R, V, K = W.shape
    D = X.shape[1]
    W_out = torch.empty_like(W)
    H_out = torch.empty_like(H)
    H_scratch = torch.empty_like(H)
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        status = lib.mu_block_launch(
            X.data_ptr(), W.data_ptr(), H.data_ptr(), W_out.data_ptr(),
            H_out.data_ptr(), H_scratch.data_ptr(), R, V, K, D,
            int(n_steps), stream,
        )
    if status != 0:
        message = lib.mu_block_error_string(status).decode()
        raise RuntimeError(f"mu_block_launch failed: {message} ({status})")
    fused_mu_block.launches += 1
    return W_out, H_out


fused_mu_block.launches = 0


def fused_block_update(params, data, n_steps: int):
    """Engine block update through the kernel: params {"W", "H"} with or
    without a leading restart axis, data {"X"}."""
    W, H = params["W"], params["H"]
    single = W.dim() == 2
    if single:
        W, H = W.unsqueeze(0), H.unsqueeze(0)
    W, H = fused_mu_block(data["X"], W.contiguous(), H.contiguous(), n_steps)
    if single:
        W, H = W.squeeze(0), H.squeeze(0)
    return {"W": W, "H": H}
