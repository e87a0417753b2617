"""The fused KLNMF multiplicative-update block: the CUDA kernels of
csrc/mu_block.cu, their launch plan, build and binding, and their plain
PyTorch version.

Held against salamander_tpu/ops/pallas_klnmf.py::fused_mu_block, with a
leading restart axis: W (R, V, K) and H (R, K, D) advance by ``n_steps``
joint updates against one X (V, D), or against each lane's own X (R, V, D)
(a bootstrap resample per lane: the JAX kernel under ``vmap`` over X too).
``n_steps`` is a run-time argument, so one binary serves the fit loop's
full blocks and its remainder tail.

Two kernels compute the block. The resident kernel keeps a lane's X, W and
H in shared memory for every step, on a thread block cluster of C CTAs per
lane (C > 1 when the lanes are too few to fill the card); the streamed
kernel reads X from L2 in 32-sample tiles and takes any D. The route is
decided from the shapes alone, before the launch (:func:`plan_launch`,
twin of mu_block_plan in the source).

Build: nvcc compiles the source for sm_90a into a shared library with a
plain C interface, at first use, under ``build/`` at the root of the
checkout (named by a hash of the source, so an edited source builds anew),
and ``ctypes`` loads it. Nothing is built or imported when this module is
imported.

Routing is decided before a launch, never on failure:
:func:`mu_block_supported` says whether a fit's block update may run a
kernel. :func:`fused_mu_block` runs the plain version for tensors on the
CPU and launches the planned kernel for tensors on a card; a build or
launch error raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from .klnmf import update_WH

K_MAX = 32          # MU_BLOCK_K_MAX in csrc/mu_block.cu
THREADS = 256       # MU_BLOCK_THREADS
_TILE_PITCH = 33    # MU_BLOCK_TILE_D + 1
_WARPS = THREADS // 32
_SHARED_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_CLUSTERS = (1, 2, 4, 8)
_MIN_SAMPLES_PER_CTA = 16
_NUM_PARTIALS = 16  # kNumPartials: partial sums a warp keeps per numerator entry

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mu_block.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_VARIANT_CODES = {None: 0, "resident": 1, "streamed": 2}


class LaunchPlan(NamedTuple):
    """How a block update launches: the kernel ("resident", "streamed",
    or None where neither takes the shapes), the CTAs per lane (a thread
    block cluster), the threads per CTA and its dynamic shared bytes."""
    variant: str | None
    cluster: int
    threads: int
    shared_bytes: int


def shared_bytes(n_features: int, n_signatures: int) -> int:
    """Dynamic shared memory of one streamed block
    (mu_block_shared_bytes)."""
    return 4 * (2 * n_features * n_signatures
                + (n_features + n_signatures) * _TILE_PITCH)


def _samples_per_cta(D: int, cluster: int) -> int:
    return -(-D // cluster)


def padded_rank(K: int) -> int:
    """The compile-time rank the resident kernel runs K at (W and H are
    zero-padded to it in shared memory): K up to 8, else the next of 12,
    16, 24, 32 (csrc/mu_block.cu::padded_rank)."""
    return K if K <= 8 else next(t for t in (12, 16, 24, 32) if K <= t)


_CHUNK_COUNTS = (1, 2, 3, 4, 6, 8)  # the template's chunks per warp


def chunk_counts(KT: int) -> tuple:
    """The chunks per warp the resident kernel is built for at compile-time
    rank KT (csrc/mu_block.cu::chunks_allowed): a lane keeps 2 * NC * KT
    floats in registers."""
    most = 8 if KT <= 8 else 4 if KT <= 12 else 3 if KT <= 16 else \
        2 if KT <= 24 else 1
    return tuple(n for n in _CHUNK_COUNTS if n <= most)


def _chunk_split(dc: int, K: int):
    """(WC, NC): warps along a CTA's `dc` samples and the 32-sample chunks
    each owns, or None (csrc/mu_block.cu::chunk_split): the fewest chunks
    computed, then the fewest warps along the samples."""
    allowed = chunk_counts(padded_rank(K))
    chunks = -(-dc // 32)
    splits = [(wc * nc, wc, nc) for wc in (1, 2, 4, 8)
              for nc in [min((n for n in _CHUNK_COUNTS
                              if n >= -(-chunks // wc)), default=None)]
              if nc in allowed]
    return min(splits)[1:] if splits else None


def resident_shared_bytes(V: int, K: int, D: int, cluster: int) -> int:
    """Dynamic shared memory of one resident CTA with clusters of
    `cluster`, or 0 if a lane does not fit (the per-warp register arrays
    or the 227 KB). Layout in csrc/mu_block.cu::resident_floats."""
    dc = _samples_per_cta(D, cluster)
    split = _chunk_split(dc, K)
    if split is None:
        return 0
    wc = split[0]
    KT = padded_rank(K)
    pitch = -(-dc // 4) * 4
    floats = (V * pitch + wc * V * K * _NUM_PARTIALS + V * KT + KT * dc
              + (_WARPS // wc) * K * dc + 2 * cluster * V * K)
    return 4 * floats if 4 * floats <= _SHARED_LIMIT else 0


def plan_launch(R: int, V: int, K: int, D: int, n_sms: int) -> LaunchPlan:
    """The kernel, cluster size, threads and shared bytes of a block
    update of R lanes of X (V, D) at rank K on a card with `n_sms` SMs.

    The resident kernel with the largest cluster C in 1, 2, 4, 8 such that
    R * C <= n_sms and each CTA keeps >= 16 samples; where a lane does not
    fit there, the streamed kernel; where that does not fit either, the
    resident kernel at the smallest cluster (>= 16 samples a CTA) that
    fits. So whether a kernel takes the shapes does not depend on n_sms.
    Twin of mu_block_plan in csrc/mu_block.cu."""
    if min(R, V, K, D) <= 0 or K > K_MAX:
        return LaunchPlan(None, 1, THREADS, 0)
    cluster = max(c for c in _CLUSTERS
                  if c == 1 or (R * c <= n_sms and _samples_per_cta(D, c)
                                >= _MIN_SAMPLES_PER_CTA))
    shared = resident_shared_bytes(V, K, D, cluster)
    if shared:
        return LaunchPlan("resident", cluster, THREADS, shared)
    if shared_bytes(V, K) <= _SHARED_LIMIT:
        return LaunchPlan("streamed", 1, THREADS, shared_bytes(V, K))
    for other in _CLUSTERS:
        if other > 1 and _samples_per_cta(D, other) < _MIN_SAMPLES_PER_CTA:
            break
        shared = resident_shared_bytes(V, K, D, other)
        if shared:
            return LaunchPlan("resident", other, THREADS, shared)
    return LaunchPlan(None, 1, THREADS, 0)


def unsupported_reason(X, W, H, data=None, n_given_signatures: int = 0,
                       mask=None, sample_sharded: bool = False):
    """Why no kernel can run this block update, or None if one can.

    The kernels cover float32, unweighted, unpadded fits without given
    signatures, with K <= K_MAX and a lane that one of them holds in
    shared memory, on a card; X is (V, D), or (R, V, D) with one count
    matrix per lane of W (R, V, K). Every other configuration runs the plain
    update (as the JAX package runs XLA); a rank `mask` marks a padded
    (rank-masked) fit. Whether a kernel takes the shapes does not depend
    on the card's SM count (see plan_launch). A `sample_sharded` block
    (each rank of a mesh's sample axis holds a block of D) runs the plain
    update too: the kernel sums the W numerator over all of D inside its
    body, where the plain update all-reduces it once a step. On a
    restart-only mesh each rank's lanes take the kernel as without one.
    """
    if sample_sharded:
        return ("the kernel sums the W numerator over all of D: a "
                "sample-sharded block runs the plain update")
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
    if X.dim() == 3 and (W.dim() != 3 or X.shape[0] != W.shape[0]):
        return "a per-lane X needs one lane of W per lane of X"
    if X.dim() not in (2, 3):
        return "X is (V, D) or (R, V, D)"
    if n_signatures > K_MAX:
        return f"K={n_signatures} above K_MAX={K_MAX}"
    n_lanes = W.shape[0] if W.dim() == 3 else 1
    if plan_launch(n_lanes, n_features, n_signatures, H.shape[-1],
                   n_sms=1).variant is None:
        return (f"V={n_features}, K={n_signatures}, D={H.shape[-1]} exceed "
                "shared memory in both kernels")
    if not all(t.is_cuda for t in (X, W, H)):
        return "the tensors are not on a CUDA device"
    return None


def mu_block_supported(X, W, H, data=None, n_given_signatures: int = 0,
                       mask=None, sample_sharded: bool = False):
    """Whether a fit's block update runs a kernel (see
    unsupported_reason)."""
    return unsupported_reason(X, W, H, data, n_given_signatures, mask,
                              sample_sharded) is None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    found = shutil.which("nvcc") or (str(candidate) if candidate.exists()
                                     else None)
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/mu_block.cu")
    return found


# the resident kernel's compile-time ranks, one translation unit each
# (MU_BLOCK_RANKS in csrc/mu_block.cu)
_RANK_PARTS = (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32)


def _run_all(commands):
    """Run the commands at once; raise with the output of one that
    fails. Returns their outputs."""
    processes = [subprocess.Popen(command, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for command in commands]
    outputs = [process.communicate()[0] for process in processes]
    for process, output in zip(processes, outputs):
        if process.returncode != 0:
            raise RuntimeError(f"nvcc failed ({process.returncode}):\n"
                               f"{output}")
    return outputs


def build() -> Path:
    """Compile csrc/mu_block.cu for sm_90a (once per source version) and
    return the shared library's path. The resident kernel's ranks compile
    as separate units in parallel and link with the C interface's unit.
    ptxas's register, spill and shared-memory report is kept beside the
    library with the suffix '.log'."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    library = BUILD_DIR / f"mu_block-{digest}.so"
    if library.exists():
        return library
    work = BUILD_DIR / f"mu_block-{digest}.{os.getpid()}.parts"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"]
    parts = [(work / "interface.o", [])] + [
        (work / f"rank{rank}.o", [f"-DMU_BLOCK_RANK_PART={rank}"])
        for rank in _RANK_PARTS]
    outputs = _run_all([[nvcc, *flags, *defines, "-o", str(obj), str(SOURCE)]
                        for obj, defines in parts])
    partial = library.with_name(f"{library.name}.{os.getpid()}.partial")
    _run_all([[nvcc, "-shared", "-o", str(partial),
               *(str(obj) for obj, _ in parts)]])
    library.with_suffix(".log").write_text("".join(
        f"== {obj.stem}\n{output}" for (obj, _), output in zip(parts,
                                                                outputs)))
    shutil.rmtree(work)
    os.replace(partial, library)  # atomic: concurrent builds agree
    return library


# shapes on which _library() holds plan_launch against mu_block_plan:
# PCAWG SBS at the headline's lanes, one lane, the R=40 and R=20 scans, a
# D that limits the cluster, the largest rank, the streamed catalog and
# one that neither kernel takes
_PLAN_CHECKS = ((100, 96, 5, 192), (1, 96, 5, 192), (40, 96, 5, 192),
                (20, 96, 10, 192), (1, 96, 5, 100), (4, 96, 32, 192),
                (4, 96, 20, 192), (100, 96, 13, 192),
                (20, 96, 10, 10000), (1, 4096, 3, 20), (1, 83, 5, 17))


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()))
    pointer, integer = ctypes.c_void_p, ctypes.c_int
    lib.mu_block_launch.argtypes = [pointer] * 6 + [integer] * 7 + [
        ctypes.c_longlong, pointer]
    lib.mu_block_launch.restype = integer
    lib.mu_block_error_string.argtypes = [integer]
    lib.mu_block_error_string.restype = ctypes.c_char_p
    lib.mu_block_k_max.argtypes = []
    lib.mu_block_k_max.restype = integer
    lib.mu_block_threads.argtypes = []
    lib.mu_block_threads.restype = integer
    lib.mu_block_shared_bytes.argtypes = [integer, integer]
    lib.mu_block_shared_bytes.restype = ctypes.c_size_t
    lib.mu_block_plan.argtypes = [integer] * 5 + [
        ctypes.POINTER(integer), ctypes.POINTER(integer),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.mu_block_plan.restype = None
    if lib.mu_block_k_max() != K_MAX or lib.mu_block_threads() != THREADS \
            or lib.mu_block_shared_bytes(96, 5) != shared_bytes(96, 5):
        raise RuntimeError("csrc/mu_block.cu and ops/cuda_klnmf.py disagree "
                           "on K_MAX, the threads or the streamed layout")
    for shape in _PLAN_CHECKS:
        for n_sms in (132, 1):
            if _c_plan(lib, *shape, n_sms) != plan_launch(*shape, n_sms):
                raise RuntimeError(
                    "csrc/mu_block.cu and ops/cuda_klnmf.py disagree on the "
                    f"launch plan of (R, V, K, D) = {shape}, {n_sms} SMs")
    return lib


def _c_plan(lib, R, V, K, D, n_sms) -> LaunchPlan:
    variant, cluster = ctypes.c_int(), ctypes.c_int()
    shared = ctypes.c_size_t()
    lib.mu_block_plan(R, V, K, D, n_sms, ctypes.byref(variant),
                      ctypes.byref(cluster), ctypes.byref(shared))
    name = {code: key for key, code in _VARIANT_CODES.items()}[variant.value]
    return LaunchPlan(name, cluster.value, THREADS, shared.value)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def fused_mu_block_reference(X, W, H, n_steps: int):
    """Plain PyTorch version: n_steps joint updates (ops.klnmf.update_WH)
    of W (R, V, K) and H (R, K, D) against X (V, D) or (R, V, D), which
    broadcasts."""
    for _ in range(int(n_steps)):
        W, H = update_WH(X, W, H)
    return W, H


def _check_kernel_inputs(X, W, H):
    reason = unsupported_reason(X, W, H)
    if reason is not None:
        raise ValueError(f"fused_mu_block cannot launch: {reason}")
    if X.dim() not in (2, 3) or W.dim() != 3 or H.dim() != 3:
        raise ValueError("fused_mu_block takes X (V, D) or (R, V, D), "
                         "W (R, V, K) and H (R, K, D)")
    (V, D), (R, V_w, K) = X.shape[-2:], W.shape
    if V_w != V or tuple(H.shape) != (R, K, D) or \
            (X.dim() == 3 and X.shape[0] != R):
        raise ValueError(f"shapes disagree: X {tuple(X.shape)}, W "
                         f"{tuple(W.shape)}, H {tuple(H.shape)}")
    if len({t.device for t in (X, W, H)}) != 1:
        raise ValueError("X, W and H must lie on one device")
    if not all(t.is_contiguous() for t in (X, W, H)):
        raise ValueError("fused_mu_block takes contiguous tensors")


def _launch(X, W, H, n_steps: int, plan: LaunchPlan):
    R, V, K = W.shape
    D = X.shape[-1]
    x_stride = V * D if X.dim() == 3 else 0
    W_out = torch.empty_like(W)
    H_out = torch.empty_like(H)
    H_scratch = torch.empty_like(H) if plan.variant == "streamed" else None
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        status = lib.mu_block_launch(
            X.data_ptr(), W.data_ptr(), H.data_ptr(), W_out.data_ptr(),
            H_out.data_ptr(),
            None if H_scratch is None else H_scratch.data_ptr(),
            R, V, K, D, int(n_steps), _VARIANT_CODES[plan.variant],
            plan.cluster, x_stride, stream,
        )
    if status != 0:
        message = lib.mu_block_error_string(status).decode()
        raise RuntimeError(f"mu_block_launch ({plan.variant}, cluster "
                           f"{plan.cluster}) failed: {message} ({status})")
    fused_mu_block.launches += 1
    fused_mu_block.launches_by_variant[plan.variant] += 1
    fused_mu_block.launches_by_x["per_lane" if x_stride else "shared"] += 1
    return W_out, H_out


def launch_plan(X, W) -> LaunchPlan:
    """The plan fused_mu_block launches for X (V, D) or (R, V, D) and W
    (R, V, K) on their card. A lane's shared memory does not depend on
    whether X is shared, so neither does the plan."""
    R, V, K = W.shape
    return plan_launch(R, V, K, X.shape[-1], _sm_count(X.device.index))


def fused_mu_block(X, W, H, n_steps: int):
    """Advance W (R, V, K) and H (R, K, D) by n_steps joint multiplicative
    updates against X (V, D), or against each lane's own X (R, V, D).

    CPU tensors run fused_mu_block_reference. CUDA tensors launch the
    kernel that plan_launch picks from the shapes, on the current stream,
    or raise if neither kernel takes them. Each launch adds one to
    ``fused_mu_block.launches``, to its kernel's entry of
    ``fused_mu_block.launches_by_variant`` and to the entry of
    ``fused_mu_block.launches_by_x`` for a shared or a per-lane X.
    """
    if all(t.device.type == "cpu" for t in (X, W, H)):
        return fused_mu_block_reference(X, W, H, n_steps)
    _check_kernel_inputs(X, W, H)
    return _launch(X, W, H, n_steps, launch_plan(X, W))


fused_mu_block.launches = 0
fused_mu_block.launches_by_variant = {"resident": 0, "streamed": 0}
fused_mu_block.launches_by_x = {"shared": 0, "per_lane": 0}


def _fused_mu_block_variant(X, W, H, n_steps: int, variant: str,
                            cluster: int = 1):
    """fused_mu_block through a named kernel ("resident" with clusters of
    `cluster`, or "streamed") on CUDA tensors, whatever the plan: for
    holding each kernel against the plain version on the card."""
    _check_kernel_inputs(X, W, H)
    R, V, K = W.shape
    D = X.shape[-1]
    if variant == "resident":
        shared = resident_shared_bytes(V, K, D, cluster)
        if cluster not in _CLUSTERS or not shared:
            raise ValueError(f"the resident kernel does not take V={V}, "
                             f"K={K}, D={D} with clusters of {cluster}")
        plan = LaunchPlan("resident", cluster, THREADS, shared)
    elif variant == "streamed":
        if shared_bytes(V, K) > _SHARED_LIMIT:
            raise ValueError(f"the streamed kernel does not take V={V}, "
                             f"K={K}")
        plan = LaunchPlan("streamed", 1, THREADS, shared_bytes(V, K))
    else:
        raise ValueError(f"unknown kernel {variant!r}")
    return _launch(X, W, H, n_steps, plan)


def _kernels_taking(V: int, K: int, D: int):
    """Every (kernel, cluster) that takes a lane of X (V, D) at rank K:
    the resident kernel at each cluster size that holds it, and the
    streamed kernel. For holding each against the plain version."""
    names = [("resident", c) for c in _CLUSTERS
             if resident_shared_bytes(V, K, D, c)]
    if shared_bytes(V, K) <= _SHARED_LIMIT:
        names.append(("streamed", 1))
    return names


def fused_block_update(params, data, n_steps: int):
    """Engine block update through the kernel: params {"W", "H"} with or
    without a leading restart axis, data {"X"} shared (V, D) or per lane
    (R, V, D)."""
    W, H = params["W"], params["H"]
    single = W.dim() == 2
    if single:
        W, H = W.unsqueeze(0), H.unsqueeze(0)
    W, H = fused_mu_block(data["X"], W.contiguous(), H.contiguous(), n_steps)
    if single:
        W, H = W.squeeze(0), H.squeeze(0)
    return {"W": W, "H": H}
