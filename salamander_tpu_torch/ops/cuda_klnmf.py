"""The fused KLNMF multiplicative-update block: the CUDA kernels of
csrc/mu_block.cu, their launch plan, build and binding, and their plain
PyTorch version.

Held against salamander_tpu/ops/pallas_klnmf.py::fused_mu_block, with a
leading restart axis: W (R, V, K) and H (R, K, D) advance by ``n_steps``
joint updates against one X (V, D), or against each lane's own X (R, V, D)
(a bootstrap resample per lane: the JAX kernel under ``vmap`` over X too).
``n_steps`` is a run-time argument, so one binary serves the fit loop's
full blocks and its remainder tail. Asked for it (``objective=`` a dtype,
also a run-time argument), a launch also returns each lane's convergence
objective of the W', H' it writes (ops.klnmf.kl_divergence, in float32 or
in float64 as models.signature_nmf.promote_objective evaluates it), from
one more pass over X after the last step.

Two kernels compute the block. The resident kernel keeps a lane's X, W and
H in shared memory for every step, on a thread block cluster of C CTAs per
lane (C > 1 when the lanes are too few to fill the card); the streamed
kernel takes any D: it splits each lane's samples over S CTAs (S > 1 when
the lanes are too few to fill the card, through a cooperative launch) and
streams X and H through shared memory in tiles. The route is decided from
the shapes alone, before the launch (:func:`plan_launch`, twin of
mu_block_plan in the source).

Build: nvcc compiles the source for sm_90a into a shared library with a
plain C interface, at first use, under ``build/`` at the root of the
checkout (named by a hash of the source, so an edited source builds anew),
and ``ctypes`` loads it. Nothing is built or imported when this module is
imported.

Routing is decided before a launch, never on failure, and in one place:
:func:`klnmf_block` gives a KLNMF fit the kernel's block update
(:class:`KernelBlock`) where :func:`unsupported_reason` is None, else None,
and the fit runs its plain block. :func:`fused_mu_block` runs the plain
version for tensors on the CPU and launches the planned kernel for tensors
on a card; a build or launch error raises.
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

from .klnmf import kl_divergence, update_WH

K_MAX = 32          # MU_BLOCK_K_MAX in csrc/mu_block.cu
THREADS = 256       # MU_BLOCK_THREADS
_WARPS = THREADS // 32
_SHARED_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_CLUSTERS = (1, 2, 4, 8)
_MIN_SAMPLES_PER_CTA = 16
_NUM_PARTIALS = 16  # kNumPartials: partial sums a warp keeps per numerator entry

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mu_block.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_VARIANT_CODES = {None: 0, "resident": 1, "streamed": 2}
# the objective a launch returns: mu_block_launch's objective_mode
_OBJECTIVE_CODES = {None: 0, torch.float32: 1, torch.float64: 2}


class LaunchPlan(NamedTuple):
    """How a block update launches: the kernel ("resident", "streamed",
    or None where neither takes the shapes), the CTAs per lane (the
    resident kernel's thread block cluster, or the streamed kernel's split
    S), the threads per CTA and its dynamic shared bytes."""
    variant: str | None
    cluster: int
    threads: int
    shared_bytes: int


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


def stream_rank(K: int) -> int:
    """The compile-time rank the streamed kernel runs K at: K up to 8,
    else K rounded up to a multiple of 4 (csrc/mu_block.cu::stream_rank)."""
    return K if K <= 8 else -(-K // 4) * 4


def stream_tile(K: int) -> int:
    """Samples of one streamed tile at rank K: 32 times the chunks a warp
    keeps in registers (csrc/mu_block.cu::stream_tile)."""
    KT = stream_rank(K)
    return 32 * (4 if KT <= 12 else 3 if KT <= 20 else 2 if KT <= 24 else 1)


def _stream_partials(K: int) -> int:
    return 16 if stream_rank(K) <= 5 else 8


def streamed_split(R: int, K: int, D: int, n_sms: int) -> int:
    """The CTAs S a lane is split over (csrc/mu_block.cu::streamed_split):
    the most with R * S <= n_sms and at least one tile each (1 where the
    lanes alone fill the card), evened so every CTA holds the same whole
    number of tiles but the last."""
    tiles = -(-D // stream_tile(K))
    first = min(1 if R >= n_sms else n_sms // R, tiles)
    per = -(-tiles // first)
    return -(-tiles // per)


def streamed_layout(V: int, K: int, D: int, split: int):
    """(shared bytes, samples a CTA owns, ring depth) of the streamed
    kernel with each lane split over `split` CTAs, or None if it does not
    take the shapes (a CTA would own no sample, or two tile slots exceed
    the 227 KB, whatever the split). Depth 0: every tile of a CTA stays in
    shared memory for all steps. Layout in
    csrc/mu_block.cu::streamed_shared_bytes."""
    KT, T = stream_rank(K), stream_tile(K)
    tiles = -(-D // T)
    if not 1 <= split <= tiles:
        return None
    per = -(-tiles // split)
    if (split - 1) * per * T >= D:
        return None
    fixed = V * KT + V * K * _stream_partials(K) + _WARPS * K * T + V * K
    slot = (V + K) * T
    if 4 * (fixed + 2 * slot) > _SHARED_LIMIT:  # at any split, so support
        return None                             # does not depend on it
    for stages, slots in ((0, per), (3, 3), (2, 2)):
        if 4 * (fixed + slots * slot) <= _SHARED_LIMIT:
            return 4 * (fixed + slots * slot), per * T, stages
    return None


def shared_bytes(V: int, K: int, D: int, split: int) -> int:
    """Dynamic shared memory of one streamed CTA, or 0 if the streamed
    kernel does not take the shapes (mu_block_shared_bytes)."""
    layout = streamed_layout(V, K, D, split)
    return 0 if layout is None else layout[0]


def plan_launch(R: int, V: int, K: int, D: int, n_sms: int) -> LaunchPlan:
    """The kernel, cluster size, threads and shared bytes of a block
    update of R lanes of X (V, D) at rank K on a card with `n_sms` SMs.

    The resident kernel with the largest cluster C in 1, 2, 4, 8 such that
    R * C <= n_sms and each CTA keeps >= 16 samples; where a lane does not
    fit there, the streamed kernel split over streamed_split's S CTAs a
    lane (R * S <= n_sms where S > 1); where that does not fit either, the
    resident kernel at the smallest cluster (>= 16 samples a CTA) that
    fits. The streamed kernel takes the shapes at S = 1 wherever it takes
    them at all, so whether a kernel takes the shapes does not depend on
    n_sms. Twin of mu_block_plan in csrc/mu_block.cu."""
    if min(R, V, K, D) <= 0 or K > K_MAX:
        return LaunchPlan(None, 1, THREADS, 0)
    cluster = max(c for c in _CLUSTERS
                  if c == 1 or (R * c <= n_sms and _samples_per_cta(D, c)
                                >= _MIN_SAMPLES_PER_CTA))
    shared = resident_shared_bytes(V, K, D, cluster)
    if shared:
        return LaunchPlan("resident", cluster, THREADS, shared)
    split = streamed_split(R, K, D, n_sms)
    shared = shared_bytes(V, K, D, split)
    if shared:
        return LaunchPlan("streamed", split, THREADS, shared)
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
    if data.get("weights_kl") is not None or \
            data.get("weights_lhalf") is not None:
        return "the kernel has no loss weights"
    if mask is not None:
        return "the kernel has no rank mask"
    if X.dim() == 3 and (W.dim() != 3 or X.shape[0] != W.shape[0]):
        return "a per-lane X needs one lane of W per lane of X"
    if X.dim() not in (2, 3):
        return "X is (V, D) or (R, V, D)"
    return unsupported_fit_reason(
        {X.dtype, W.dtype, H.dtype}, all(t.is_cuda for t in (X, W, H)),
        n_given_signatures, W.shape[0] if W.dim() == 3 else 1, *W.shape[-2:],
        H.shape[-1])


def unsupported_fit_reason(dtypes, on_card: bool, n_given_signatures: int,
                           n_lanes: int, n_features: int, n_signatures: int,
                           n_samples: int):
    """Why no kernel can run an unweighted, unpadded fit of these
    properties, or None if one can: its tensors' `dtypes` (a set), whether
    they lie on a card, its lanes and V, K, D. Whether a kernel takes the
    shapes does not depend on the number of lanes (plan_launch at one SM),
    so extraction's layout asks this from the shapes, before any lane
    exists; unsupported_reason asks it for every block."""
    if dtypes != {torch.float32}:
        return "the kernel is float32 only"
    if n_given_signatures:
        return "the kernel has no given signatures"
    if n_signatures > K_MAX:
        return f"K={n_signatures} above K_MAX={K_MAX}"
    if plan_launch(n_lanes, n_features, n_signatures, n_samples,
                   n_sms=1).variant is None:
        return (f"V={n_features}, K={n_signatures}, D={n_samples} exceed "
                "shared memory in both kernels")
    if not on_card:
        return "the tensors are not on a CUDA device"
    return None


def klnmf_block(params, data, n_given_signatures: int = 0, mask=None,
                sample_sharded: bool = False):
    """The kernel's block update (params, n_steps) -> params for a KLNMF
    fit of `params` {"W", "H"} on `data`, a KernelBlock bound to `data`,
    where unsupported_reason holds none for these tensors; else None, and
    the fit runs its plain block (its update n_steps times). The one place
    a KLNMF block's route is decided, before any launch."""
    if unsupported_reason(data["X"], params["W"], params["H"], data,
                          n_given_signatures, mask, sample_sharded) is None:
        return KernelBlock(data)
    return None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    found = shutil.which("nvcc") or (str(candidate) if candidate.exists()
                                     else None)
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels of csrc/")
    return found


# nvcc's flags for every unit of csrc/: sm_90a, with ptxas's report
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_library(name: str, source: Path, compile_into) -> Path:
    """The shared library ``build/<name>-<digest>.so`` of `source`, named
    by a hash of the source and built once per source version:
    compile_into(nvcc, partial) writes the library to the path `partial`
    and returns ptxas's register, spill and shared-memory report, which is
    kept beside the library with the suffix '.log'."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    library = BUILD_DIR / f"{name}-{digest}.so"
    if library.exists():
        return library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = library.with_name(f"{library.name}.{os.getpid()}.partial")
    library.with_suffix(".log").write_text(compile_into(_nvcc(), partial))
    os.replace(partial, library)  # atomic: concurrent builds agree
    return library


# the kernels' compile-time ranks, one translation unit each (the resident
# kernel at each chunk count and the streamed kernel; MU_BLOCK_RANKS in
# csrc/mu_block.cu)
_RANK_PARTS = (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32)
# the streamed kernel's ranks (MU_BLOCK_STREAM_RANKS): 20 and 28 build in
# the units of 24 and 32
_STREAM_RANKS = _RANK_PARTS + (20, 28)


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
    return the shared library's path. The kernels' ranks compile as
    separate units in parallel and link with the C interface's unit;
    their ptxas reports are kept in one '.log' (build_library)."""
    def compile_into(nvcc, partial):
        work = partial.with_suffix(".parts")
        work.mkdir(exist_ok=True)
        parts = [(work / "interface.o", [])] + [
            (work / f"rank{rank}.o", [f"-DMU_BLOCK_RANK_PART={rank}"])
            for rank in _RANK_PARTS]
        outputs = _run_all([[nvcc, *NVCC_FLAGS, "-c", *defines, "-o",
                             str(obj), str(SOURCE)]
                            for obj, defines in parts])
        _run_all([[nvcc, "-shared", "-o", str(partial),
                   *(str(obj) for obj, _ in parts)]])
        shutil.rmtree(work)
        return "".join(f"== {obj.stem}\n{output}"
                       for (obj, _), output in zip(parts, outputs))

    return build_library("mu_block", SOURCE, compile_into)


# shapes on which _library() holds plan_launch against mu_block_plan:
# PCAWG SBS at the headline's lanes, one lane, the R=40 and R=20 scans, a
# D that limits the cluster, the largest rank, the cohort shapes (the
# 96 x 10,000 scan at R = 100 and 20, one fit, a cell 7b rank group of 10
# lanes and one lane at 96 x 200,000, an unaligned D, a D the resident
# kernel just misses) and one that neither kernel takes
_PLAN_CHECKS = ((100, 96, 5, 192), (1, 96, 5, 192), (40, 96, 5, 192),
                (20, 96, 10, 192), (1, 96, 5, 100), (4, 96, 32, 192),
                (4, 96, 20, 192), (100, 96, 13, 192),
                (20, 96, 10, 10000), (100, 96, 5, 10000),
                (100, 96, 20, 10000), (100, 96, 32, 10000),
                (1, 96, 8, 10000), (10, 96, 5, 200000),
                (1, 96, 5, 200000), (4, 96, 5, 9999), (2, 96, 5, 2500),
                (1, 4096, 3, 20), (1, 83, 5, 17))

# (V, K, D, split) on which _library() holds shared_bytes against
# mu_block_shared_bytes: each ring depth, kept tiles, an invalid split
_SHARED_CHECKS = ((96, 5, 10000, 1), (96, 8, 10000, 1), (96, 20, 10000, 6),
                  (96, 8, 10000, 79), (96, 5, 200000, 13), (96, 5, 9999, 4),
                  (96, 5, 192, 3))


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()))
    pointer, integer = ctypes.c_void_p, ctypes.c_int
    lib.mu_block_launch.argtypes = [pointer] * 6 + [integer] * 7 + [
        ctypes.c_longlong, integer, pointer, pointer]
    lib.mu_block_launch.restype = integer
    lib.mu_block_error_string.argtypes = [integer]
    lib.mu_block_error_string.restype = ctypes.c_char_p
    lib.mu_block_k_max.argtypes = []
    lib.mu_block_k_max.restype = integer
    lib.mu_block_threads.argtypes = []
    lib.mu_block_threads.restype = integer
    lib.mu_block_shared_bytes.argtypes = [integer] * 4
    lib.mu_block_shared_bytes.restype = ctypes.c_size_t
    lib.mu_block_plan.argtypes = [integer] * 5 + [
        ctypes.POINTER(integer), ctypes.POINTER(integer),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.mu_block_plan.restype = None
    if lib.mu_block_k_max() != K_MAX or lib.mu_block_threads() != THREADS \
            or any(lib.mu_block_shared_bytes(*shape) != shared_bytes(*shape)
                   for shape in _SHARED_CHECKS):
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


def block_objective_of(X, W, H, dtype):
    """The objective a launch returns: ops.klnmf.kl_divergence of W, H
    against X, its operands cast to `dtype` (promote_objective's float64,
    or the parameters' own)."""
    return kl_divergence(X.to(dtype), W.to(dtype), H.to(dtype))


def fused_mu_block_reference(X, W, H, n_steps: int, objective=None):
    """Plain PyTorch version: n_steps joint updates (ops.klnmf.update_WH)
    of W (R, V, K) and H (R, K, D) against X (V, D) or (R, V, D), which
    broadcasts; with `objective` a dtype, also each lane's objective of the
    result (block_objective_of)."""
    for _ in range(int(n_steps)):
        W, H = update_WH(X, W, H)
    if objective is None:
        return W, H
    return W, H, block_objective_of(X, W, H, objective)


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


def _launch(X, W, H, n_steps: int, plan: LaunchPlan, objective=None):
    R, V, K = W.shape
    D = X.shape[-1]
    x_stride = V * D if X.dim() == 3 else 0
    W_out = torch.empty_like(W)
    H_out = torch.empty_like(H)
    values = None
    if objective is not None:
        if objective not in _OBJECTIVE_CODES or int(n_steps) < 1:
            raise ValueError("a launch returns the objective in float32 or "
                             f"float64 after >= 1 step, not {objective} "
                             f"after {n_steps}")
        values = torch.empty(R, dtype=objective, device=X.device)
    workspace = None
    if plan.variant == "streamed" and plan.cluster > 1:
        # the lanes' arrival counters (zeroed), two rounds of the CTAs'
        # numerators, and the CTAs' objective sums (mu_block_launch)
        workspace = torch.zeros(
            -(-R // 4) * 4 + 2 * R * plan.cluster * (V * K + 1),
            dtype=torch.float32, device=X.device)
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        status = lib.mu_block_launch(
            X.data_ptr(), W.data_ptr(), H.data_ptr(), W_out.data_ptr(),
            H_out.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            R, V, K, D, int(n_steps), _VARIANT_CODES[plan.variant],
            plan.cluster, x_stride, _OBJECTIVE_CODES[objective],
            None if values is None else values.data_ptr(), stream,
        )
    if status != 0:
        message = lib.mu_block_error_string(status).decode()
        raise RuntimeError(f"mu_block_launch ({plan.variant}, cluster "
                           f"{plan.cluster}) failed: {message} ({status})")
    launch = (plan.variant, "per_lane" if x_stride else "shared")
    if torch.cuda.is_current_stream_capturing():
        _captured.append(launch)  # counted at each replay of the graph
    else:
        count_replay([launch])
    return (W_out, H_out) if values is None else (W_out, H_out, values)


# the launches made while a stream was capturing a CUDA graph, since the
# last captured_launches()
_captured: list = []


def captured_launches() -> list:
    """The (kernel, X) launches recorded while a stream captured, since
    the last call, and forget them: the launches a graph holds, which
    count_replay adds at each of its replays."""
    taken = list(_captured)
    _captured.clear()
    return taken


def count_replay(launches) -> None:
    """Add (kernel, X) launches to fused_mu_block's counts: one launch, or
    the launches a CUDA graph holds when it is replayed."""
    for variant, x in launches:
        fused_mu_block.launches += 1
        fused_mu_block.launches_by_variant[variant] += 1
        fused_mu_block.launches_by_x[x] += 1


def launch_plan(X, W) -> LaunchPlan:
    """The plan fused_mu_block launches for X (V, D) or (R, V, D) and W
    (R, V, K) on their card. A lane's shared memory does not depend on
    whether X is shared, so neither does the plan."""
    R, V, K = W.shape
    return plan_launch(R, V, K, X.shape[-1], _sm_count(X.device.index))


def fused_mu_block(X, W, H, n_steps: int, objective=None):
    """Advance W (R, V, K) and H (R, K, D) by n_steps joint multiplicative
    updates against X (V, D), or against each lane's own X (R, V, D).
    With `objective` torch.float32 or torch.float64 (and n_steps >= 1),
    return (W', H', objective (R,) of that dtype): the launch's epilogue
    computes each lane's block_objective_of(X, W', H', objective).

    CPU tensors run fused_mu_block_reference. CUDA tensors launch the
    kernel that plan_launch picks from the shapes, on the current stream,
    or raise if neither kernel takes them. Each launch adds one to
    ``fused_mu_block.launches``, to its kernel's entry of
    ``fused_mu_block.launches_by_variant`` and to the entry of
    ``fused_mu_block.launches_by_x`` for a shared or a per-lane X. A call
    made while the stream captures a CUDA graph launches nothing then: it
    is counted at each replay of the graph (count_replay).
    """
    if all(t.device.type == "cpu" for t in (X, W, H)):
        return fused_mu_block_reference(X, W, H, n_steps, objective)
    _check_kernel_inputs(X, W, H)
    return _launch(X, W, H, n_steps, launch_plan(X, W), objective)


fused_mu_block.launches = 0
fused_mu_block.launches_by_variant = {"resident": 0, "streamed": 0}
fused_mu_block.launches_by_x = {"shared": 0, "per_lane": 0}


def _fused_mu_block_variant(X, W, H, n_steps: int, variant: str,
                            cluster: int = 1, objective=None):
    """fused_mu_block through a named kernel ("resident" with clusters of
    `cluster`, or "streamed" with each lane split over `cluster` CTAs) on
    CUDA tensors, whatever the plan: for holding each kernel against the
    plain version on the card."""
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
        shared = shared_bytes(V, K, D, cluster)
        if not shared or (cluster > 1
                          and R * cluster > _sm_count(X.device.index)):
            raise ValueError(f"the streamed kernel does not take V={V}, "
                             f"K={K}, D={D}, R={R} split over {cluster}")
        plan = LaunchPlan("streamed", cluster, THREADS, shared)
    else:
        raise ValueError(f"unknown kernel {variant!r}")
    return _launch(X, W, H, n_steps, plan, objective)


def _kernels_taking(R: int, V: int, K: int, D: int, n_sms: int):
    """The (kernel, cluster or split) pairs that take R lanes of X (V, D)
    at rank K on a card of `n_sms` SMs, for holding each against the plain
    version: the resident kernel at each cluster size that holds a lane,
    and the streamed kernel at the splits 1, 2 and 8 where they fit and at
    the one its plan picks."""
    names = [("resident", c) for c in _CLUSTERS
             if resident_shared_bytes(V, K, D, c)]
    splits = {1, 2, 8, streamed_split(R, K, D, n_sms)}
    names += [("streamed", S) for S in sorted(splits)
              if shared_bytes(V, K, D, S) and (S == 1 or R * S <= n_sms)]
    return names


class KernelBlock:
    """A KLNMF fit's block update through the kernel, bound to its data
    {"X"}: called as block(params, n_steps), params {"W", "H"} with or
    without a leading restart axis, X shared (V, D) or per lane (R, V, D).
    Asked with ``objective=dtype``, it returns (params, their objective in
    that dtype): (R,) from the launch, or a scalar for a single fit. On
    the CPU the plain block runs and the objective is that of the plain
    ops, on the caller's shapes.

    Its class says what the engine needs: one launch a block, no host
    read and no collective, so a fit's spans may be captured as CUDA
    graphs (`capturable`); and it gives each block's objective
    (`gives_objective`), which the engine then takes in the dtype of the
    loop's objective. Only klnmf_block builds one, and only where
    unsupported_reason is None: unweighted, unmasked, without given
    signatures or a sample axis. A KLNMF loop's objective there is the
    unweighted KL divergence, float64 where promote_objective promoted it
    and float32 where it did not, which is what the launch returns
    (block_objective_of)."""

    capturable = True
    gives_objective = True

    def __init__(self, data):
        self.data = data

    def __call__(self, params, n_steps: int, objective=None):
        W, H, X = params["W"], params["H"], self.data["X"]
        single = W.dim() == 2
        if single:
            W, H = W.unsqueeze(0), H.unsqueeze(0)
        on_card = not all(t.device.type == "cpu" for t in (X, W, H))
        out = fused_mu_block(X, W.contiguous(), H.contiguous(), n_steps,
                             objective if on_card else None)
        W, H = out[:2]
        if single:
            W, H = W.squeeze(0), H.squeeze(0)
        if objective is None:
            return {"W": W, "H": H}
        if on_card:
            value = out[2].squeeze(0) if single else out[2]
        else:
            value = block_objective_of(X, W, H, objective)
        return {"W": W, "H": H}, value
