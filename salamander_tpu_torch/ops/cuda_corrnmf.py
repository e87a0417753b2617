"""The CorrNMF Newton solve as CUDA kernels: the source
csrc/corrnmf_newton.cu, the route among its two kernels and the plain
steps, the build and binding, and the kernels' plain PyTorch versions.

``ops/corrnmf.py::update_embeddings`` asks :func:`route` once a solve:

- ``"thread"``: an unrolled solve (step cap at most
  ``_UNROLL_NEWTON_LIMIT``, the sample side's 3 steps) of rows with at most
  ``OTHERS_MAX`` others runs in one launch of the thread kernel: a thread
  per row of every lane, all of its damped Newton steps, the m x m
  Cholesky factor with its diagonal floor and the Armijo candidates in
  registers (:func:`newton_solve`);
- ``"wide"``: rows with more than ``OTHERS_MAX`` others (the signature
  side's samples), whatever the step cap, run in one launch of the wide
  kernel: a CTA, or a cluster of CTAs, per row, the sums over its others
  reduced across the CTA and the cluster, every step up to the cap on the
  card with no host read (:func:`wide_newton_solve`);
- ``"plain"``: everything else runs ops/corrnmf.py's plain steps: CPU
  tensors, reduce_samples (a sample-sharded mesh), m above ``DIM_MAX``,
  other dtypes, and narrow early-exit solves.

Both kernels keep ``_newton_step``'s arithmetic (the source's note says
which sums change order). The route reads what the call shows (devices,
dtypes, m, the others a row, the step cap, reduce_samples) before it runs,
never a failure: each wrapper runs its plain version for tensors on the
CPU and launches its kernel for tensors on a card, or raises where the
kernel does not take the call. Each launch adds one to the wrapper's
``launches``.

Build: nvcc compiles the source for sm_90a into a shared library with a
plain C interface, at first use, under ``build/`` at the root of the
checkout (named by a hash of the source), and ``ctypes`` loads it. The
library is built and loaded only when a solve launches; nothing is built
or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import corrnmf
from .cuda_klnmf import NVCC_FLAGS, _run_all, _sm_count, build_library

DIM_MAX = 10    # CORRNMF_NEWTON_DIM_MAX in csrc/corrnmf_newton.cu
# CORRNMF_NEWTON_DIM_MIN: m = 1 launches at 2 with a zero column (exact)
_DIM_MIN = 2
THREADS = 128   # CORRNMF_NEWTON_THREADS
# The most others a row the kernel takes. A thread loops over its row's M
# others serially (M exps a candidate), while the plain steps spread them
# over the card, so the kernel's time grows with M and the plain steps'
# hardly does. On an H100 (4 steps, 5 or 20 rows, one lane or 8, float32
# and float64; scripts/time_corrnmf_route.py) the kernel took at most 0.37
# of the plain time at M <= 256, 0.80 at 512, and up to 1.6 times it at
# 1,024 and 16 times at 20,000: a minibatch signature side (K rows against
# a batch of samples) at batch_size 20,000 ran 4 times slower through it.
OTHERS_MAX = 256
_MAX_LANES = 65535  # the grid's y dimension
WIDE_THREADS = 256       # CORRNMF_WIDE_THREADS: a wide row's CTA
WIDE_CLUSTER_MAX = 8     # CORRNMF_WIDE_CLUSTER_MAX
# CORRNMF_WIDE_CACHE_BYTES: the most shared memory a CTA's slice of the
# others (m + 1 values an other) may take; a larger slice is re-read a pass
WIDE_CACHE_BYTES = 204800

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "corrnmf_newton.cu"

_DTYPE_CODES = {torch.float32: 1, torch.float64: 2}


def _refusal(tensors, dim: int, reduce_samples):
    """The reasons both kernels share, but the device's (_device_refusal):
    a call either kernel cannot take whatever its rows' width."""
    if reduce_samples is not None:
        return ("the others are a rank's block of the samples: their sums "
                "are completed across ranks a step (reduce_samples)")
    if any(t.dtype not in _DTYPE_CODES for t in tensors) or \
            len({t.dtype for t in tensors}) != 1:
        return "the kernel takes float32 or float64, one dtype for all"
    if not 1 <= dim <= DIM_MAX:
        return f"m={dim} outside the compiled 1..{DIM_MAX}"
    if not tensors[0].numel() or not tensors[1].shape[-2]:
        return "no rows or no others"
    return None


def _device_refusal(tensors):
    """Why the tensors are not all on one card, or None."""
    if not all(t.is_cuda for t in tensors):
        return "the tensors are not on a CUDA device"
    if len({t.device for t in tensors}) != 1:
        return "the tensors lie on more than one device"
    return None


def unsupported_reason(embeddings0, embeddings_other, scalings,
                       scalings_other, variance, aux_mat, max_iter: int,
                       reduce_samples=None):
    """Why the thread kernel does not run this solve (update_embeddings'
    arguments), or None if it does.

    It takes an unrolled solve (max_iter <= _UNROLL_NEWTON_LIMIT) of
    float32 or float64 rows of dimension 1..DIM_MAX against at most
    OTHERS_MAX others, all on this rank (no reduce_samples), with every
    tensor on one card.
    The variance is taken in the rows' dtype and on their card, as the
    plain path takes it."""
    tensors = (embeddings0, embeddings_other, scalings, scalings_other,
               aux_mat)
    reason = _refusal(tensors, embeddings0.shape[-1], reduce_samples)
    if reason is not None:
        return reason
    if int(max_iter) > corrnmf._UNROLL_NEWTON_LIMIT:
        return (f"max_iter={int(max_iter)} is an early-exit solve (above "
                f"{corrnmf._UNROLL_NEWTON_LIMIT})")
    if embeddings_other.shape[-2] > OTHERS_MAX:
        return (f"{embeddings_other.shape[-2]} others a row, above the "
                f"{OTHERS_MAX} at which the kernel's serial loop over them "
                "outruns the plain steps")
    return _device_refusal(tensors)


def wide_unsupported_reason(embeddings0, embeddings_other, scalings,
                            scalings_other, variance, aux_mat,
                            max_iter: int, reduce_samples=None):
    """Why the wide kernel does not run this solve (update_embeddings'
    arguments), or None if it does: it takes float32 or float64 rows of
    dimension 1..DIM_MAX against more than OTHERS_MAX others, all on this
    rank, with every tensor on one card, at any step cap."""
    tensors = (embeddings0, embeddings_other, scalings, scalings_other,
               aux_mat)
    reason = _refusal(tensors, embeddings0.shape[-1], reduce_samples)
    if reason is not None:
        return reason
    if embeddings_other.shape[-2] <= OTHERS_MAX:
        return (f"{embeddings_other.shape[-2]} others a row, at most "
                f"{OTHERS_MAX}: narrow rows are the thread kernel's or the "
                "plain steps'")
    return _device_refusal(tensors)


def route(embeddings0, embeddings_other, scalings, scalings_other,
          variance, aux_mat, max_iter: int, reduce_samples=None) -> str:
    """The solve's route, from what the call shows: "thread" where the
    thread kernel takes it (unsupported_reason), else "wide" where the
    wide kernel does (wide_unsupported_reason), else "plain"."""
    args = (embeddings0, embeddings_other, scalings, scalings_other,
            variance, aux_mat, max_iter, reduce_samples)
    if unsupported_reason(*args) is None:
        return "thread"
    if wide_unsupported_reason(*args) is None:
        return "wide"
    return "plain"


def build() -> Path:
    """Compile csrc/corrnmf_newton.cu for sm_90a (once per source
    version) and return the shared library's path; ptxas's register and
    spill report is kept beside it with the suffix '.log'
    (cuda_klnmf.build_library)."""
    def compile_into(nvcc, partial):
        (output,) = _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o",
                               str(partial), str(SOURCE)]])
        return output

    return build_library("corrnmf_newton", SOURCE, compile_into)


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()))
    pointer, integer, wide = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.corrnmf_newton_launch.argtypes = (
        [integer, integer] + [pointer] * 3 + [wide] * 3 + [pointer] * 2
        + [wide] * 3 + [pointer] * 3 + [integer] * 4 + [pointer])
    lib.corrnmf_newton_launch.restype = integer
    lib.corrnmf_newton_wide_launch.argtypes = (
        [integer, integer] + [pointer] * 3 + [wide] * 3 + [pointer] * 2
        + [wide] * 3 + [pointer] * 4 + [integer] * 6 + [pointer])
    lib.corrnmf_newton_wide_launch.restype = integer
    lib.corrnmf_newton_error_string.argtypes = [integer]
    lib.corrnmf_newton_error_string.restype = ctypes.c_char_p
    names = ("dim_min", "dim_max", "threads", "wide_threads",
             "wide_cluster_max", "wide_cache_bytes")
    for name in names:
        getattr(lib, f"corrnmf_newton_{name}").argtypes = []
        getattr(lib, f"corrnmf_newton_{name}").restype = integer
    if tuple(getattr(lib, f"corrnmf_newton_{name}")() for name in names) \
            != (_DIM_MIN, DIM_MAX, THREADS, WIDE_THREADS, WIDE_CLUSTER_MAX,
                WIDE_CACHE_BYTES):
        raise RuntimeError("csrc/corrnmf_newton.cu and ops/cuda_corrnmf.py "
                           "disagree on the compiled m, the threads, the "
                           "cluster or the cache")
    return lib


def newton_solve_reference(embeddings0, embeddings_other, scalings,
                           scalings_other, variance, aux_mat, max_iter: int,
                           xtol_total=None):
    """Plain PyTorch version: ops/corrnmf.py's unrolled loop of max_iter
    masked _newton_step calls, then _clamp_away_from_zero."""
    b, _ = corrnmf._newton_solve(
        embeddings0, embeddings_other, scalings, scalings_other, variance,
        aux_mat, max_iter, xtol_total, None, False)
    return b


def _lanes(tensor, lanes, trailing):
    """`tensor` broadcast to lanes + trailing, its lanes flattened into one
    axis (a view where the strides allow)."""
    return tensor.expand(lanes + trailing).reshape((-1,) + trailing)


def _on_card(value, dtype, device):
    """A tensor or a Python number as a tensor of dtype on device; a number
    is filled there, with no copy from the host (which would wait for the
    card)."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype, device=device)
    return torch.full((), float(value), dtype=dtype, device=device)


class Operands(NamedTuple):
    """What a launch hands the kernel (the layout in the source): the
    lanes' broadcast shape; b0 (L, N, m), others (L, M, m), scal_other
    (L, M), variance and xtol (L,), contiguous; the row scalings and aux
    as (L, N, M) views (the scalings with an others' stride of 0 where a
    row has one scaling), read by their strides."""
    lanes: tuple
    b0: torch.Tensor
    others: torch.Tensor
    scalings: torch.Tensor
    scal_other: torch.Tensor
    aux: torch.Tensor
    variance: torch.Tensor
    xtol: torch.Tensor


def kernel_operands(embeddings0, embeddings_other, scalings, scalings_other,
                    variance, aux_mat, xtol_total=None) -> Operands:
    """The launch's operands from update_embeddings' arguments, broadcast
    over their lanes as the plain steps broadcast them; raises on shapes
    that disagree."""
    dtype, device = embeddings0.dtype, embeddings0.device
    N, dim = embeddings0.shape[-2:]
    M = embeddings_other.shape[-2]
    if tuple(embeddings_other.shape[-1:]) != (dim,) or \
            tuple(aux_mat.shape[-2:]) != (N, M) or \
            scalings_other.shape[-1] != M:
        raise ValueError(
            f"shapes disagree: embeddings0 {tuple(embeddings0.shape)}, "
            f"embeddings_other {tuple(embeddings_other.shape)}, aux_mat "
            f"{tuple(aux_mat.shape)}, scalings_other "
            f"{tuple(scalings_other.shape)}")
    # _newton_solve's rule: (..., N) one scaling a row, else (..., N, M)
    per_other = scalings.dim() != embeddings0.dim() - 1
    if (per_other and tuple(scalings.shape[-2:]) != (N, M)) or \
            (not per_other and scalings.shape[-1] != N):
        raise ValueError(f"scalings {tuple(scalings.shape)} fit neither "
                         f"({N},) nor ({N}, {M}) rows")
    variance = _on_card(variance, dtype, device)
    if xtol_total is None:
        xtol_total = dim * corrnmf.XTOL
    xtol_total = _on_card(xtol_total, dtype, device)
    if not per_other:
        scalings = scalings.unsqueeze(-1).expand(scalings.shape + (M,))
    # numpy's rule, not torch.broadcast_shapes: that imports torch._refs at
    # its first call, seconds of a process's set-up
    lanes = np.broadcast_shapes(
        embeddings0.shape[:-2], embeddings_other.shape[:-2],
        scalings.shape[:-2], scalings_other.shape[:-1], aux_mat.shape[:-2],
        variance.shape, xtol_total.shape)
    return Operands(
        lanes=tuple(lanes),
        b0=_lanes(embeddings0, lanes, (N, dim)).contiguous(),
        others=_lanes(embeddings_other, lanes, (M, dim)).contiguous(),
        scalings=_lanes(scalings, lanes, (N, M)),
        scal_other=_lanes(scalings_other, lanes, (M,)).contiguous(),
        aux=_lanes(aux_mat, lanes, (N, M)),
        variance=_lanes(variance, lanes, ()).contiguous(),
        xtol=_lanes(xtol_total, lanes, ()).contiguous())


def padded_dim(operands: Operands, dim: int) -> Operands:
    """The operands with b0 and the others zero-padded to `dim` columns:
    a zero column adds exact zeros to every sum, its gradient is 0 and its
    Hessian row I / variance, so it stays 0 and the other columns' steps
    are those of the unpadded rows."""
    extra = dim - operands.b0.shape[-1]
    return operands._replace(
        b0=torch.nn.functional.pad(operands.b0, (0, extra)),
        others=torch.nn.functional.pad(operands.others, (0, extra)))


def _launch(operands: Operands, max_iter: int):
    """One launch on the operands' card and current stream; the rows of
    the lanes' broadcast shape."""
    dim = operands.b0.shape[-1]
    o = padded_dim(operands, _DIM_MIN) if dim < _DIM_MIN else operands
    L, N, kernel_dim = o.b0.shape
    M = o.others.shape[1]
    if L > _MAX_LANES:
        raise ValueError(f"{L} lanes exceed the grid's {_MAX_LANES}")
    out = torch.empty_like(o.b0)
    lib = _library()
    with torch.cuda.device(o.b0.device):
        stream = torch.cuda.current_stream(o.b0.device).cuda_stream
        status = lib.corrnmf_newton_launch(
            _DTYPE_CODES[o.b0.dtype], kernel_dim, o.b0.data_ptr(),
            o.others.data_ptr(), o.scalings.data_ptr(), *o.scalings.stride(),
            o.scal_other.data_ptr(), o.aux.data_ptr(), *o.aux.stride(),
            o.variance.data_ptr(), o.xtol.data_ptr(), out.data_ptr(), L, N,
            M, int(max_iter), stream)
    if status != 0:
        message = lib.corrnmf_newton_error_string(status).decode()
        raise RuntimeError(f"corrnmf_newton_launch failed: {message} "
                           f"({status})")
    newton_solve.launches += 1
    return out[..., :dim].reshape(o.lanes + (N, dim))


def newton_solve(embeddings0, embeddings_other, scalings, scalings_other,
                 variance, aux_mat, max_iter: int, xtol_total=None):
    """The unrolled Newton solve of update_embeddings (its arguments, with
    no reduce_samples): the rows after max_iter damped Newton steps,
    clamped away from zero, of the lanes' broadcast shape.

    CPU tensors run newton_solve_reference. CUDA tensors launch the kernel
    on the current stream, or raise ValueError where it does not take the
    call (unsupported_reason). Each launch adds one to
    ``newton_solve.launches``."""
    tensors = (embeddings0, embeddings_other, scalings, scalings_other,
               aux_mat)
    if all(t.device.type == "cpu" for t in tensors):
        return newton_solve_reference(
            embeddings0, embeddings_other, scalings, scalings_other,
            variance, aux_mat, max_iter, xtol_total)
    reason = unsupported_reason(embeddings0, embeddings_other, scalings,
                                scalings_other, variance, aux_mat, max_iter)
    if reason is not None:
        raise ValueError(f"newton_solve cannot launch: {reason}")
    return solve_in_kernel(embeddings0, embeddings_other, scalings,
                           scalings_other, variance, aux_mat, max_iter,
                           xtol_total)


def solve_in_kernel(embeddings0, embeddings_other, scalings, scalings_other,
                    variance, aux_mat, max_iter: int, xtol_total=None):
    """newton_solve's launch, for a call that unsupported_reason has
    already taken (update_embeddings routes before it calls)."""
    return _launch(kernel_operands(embeddings0, embeddings_other, scalings,
                                   scalings_other, variance, aux_mat,
                                   xtol_total), max_iter)


newton_solve.launches = 0


class WidePlan(NamedTuple):
    """A wide launch's shape: each row on a cluster of `cluster` CTAs,
    their slices of the others kept in shared memory where `cached`."""
    cluster: int
    cached: bool


def wide_plan(rows: int, M: int, dim: int, itemsize: int,
              sm_count: int) -> WidePlan:
    """The cluster for `rows` rows (lanes x rows) against M others of the
    kernel's dimension `dim`: the largest power of two up to
    WIDE_CLUSTER_MAX with rows x cluster within the card's SMs and at
    least 4 others a thread of every CTA; the slices cached where each
    fits in WIDE_CACHE_BYTES."""
    cluster = 1
    while (cluster * 2 <= WIDE_CLUSTER_MAX
           and rows * cluster * 2 <= sm_count
           and M >= cluster * 2 * 4 * WIDE_THREADS):
        cluster *= 2
    chunk = -(-M // cluster)
    return WidePlan(cluster, chunk * (dim + 1) * itemsize <= WIDE_CACHE_BYTES)


def wide_newton_solve_reference(embeddings0, embeddings_other, scalings,
                                scalings_other, variance, aux_mat,
                                max_iter: int, xtol_total=None):
    """Plain PyTorch version of the wide kernel: ops/corrnmf.py's loop of
    max_iter masked _newton_step calls (early exit above
    _UNROLL_NEWTON_LIMIT), then _clamp_away_from_zero. Returns (the rows,
    each row's steps (..., N))."""
    return corrnmf._newton_solve(
        embeddings0, embeddings_other, scalings, scalings_other, variance,
        aux_mat, max_iter, xtol_total, None,
        int(max_iter) > corrnmf._UNROLL_NEWTON_LIMIT, row_steps=True)


def _launch_wide(operands: Operands, max_iter: int, plan=None):
    """One wide launch on the operands' card and current stream, by `plan`
    (wide_plan's where None). Returns every CTA's copy of the rows (lanes
    + (N, cluster, m)) and each row's steps (lanes + (N,), int32)."""
    dim = operands.b0.shape[-1]
    o = padded_dim(operands, _DIM_MIN) if dim < _DIM_MIN else operands
    L, N, kernel_dim = o.b0.shape
    M = o.others.shape[1]
    if L > _MAX_LANES:
        raise ValueError(f"{L} lanes exceed the grid's {_MAX_LANES}")
    device = o.b0.device
    if plan is None:
        plan = wide_plan(L * N, M, kernel_dim, o.b0.element_size(),
                         _sm_count(device.index))
    copies = torch.empty((L, N, plan.cluster, kernel_dim), dtype=o.b0.dtype,
                         device=device)
    steps = torch.empty((L, N), dtype=torch.int32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.corrnmf_newton_wide_launch(
            _DTYPE_CODES[o.b0.dtype], kernel_dim, o.b0.data_ptr(),
            o.others.data_ptr(), o.scalings.data_ptr(), *o.scalings.stride(),
            o.scal_other.data_ptr(), o.aux.data_ptr(), *o.aux.stride(),
            o.variance.data_ptr(), o.xtol.data_ptr(), copies.data_ptr(),
            steps.data_ptr(), L, N, M, int(max_iter), plan.cluster,
            int(plan.cached), stream)
    if status != 0:
        message = lib.corrnmf_newton_error_string(status).decode()
        raise RuntimeError(f"corrnmf_newton_wide_launch failed ({plan}): "
                           f"{message} ({status})")
    wide_newton_solve.launches += 1
    return (copies[..., :dim].reshape(o.lanes + (N, plan.cluster, dim)),
            steps.reshape(o.lanes + (N,)))


def solve_wide_in_kernel(embeddings0, embeddings_other, scalings,
                         scalings_other, variance, aux_mat, max_iter: int,
                         xtol_total=None):
    """wide_newton_solve's launch, for a call that wide_unsupported_reason
    has already taken: (the rows, each row's steps on the card)."""
    copies, steps = _launch_wide(
        kernel_operands(embeddings0, embeddings_other, scalings,
                        scalings_other, variance, aux_mat, xtol_total),
        max_iter)
    return copies[..., 0, :], steps


def wide_newton_solve(embeddings0, embeddings_other, scalings,
                      scalings_other, variance, aux_mat, max_iter: int,
                      xtol_total=None):
    """The Newton solve of update_embeddings for rows with more than
    OTHERS_MAX others (its arguments, with no reduce_samples), early exit
    above _UNROLL_NEWTON_LIMIT steps: (the rows, clamped away from zero,
    of the lanes' broadcast shape; each row's steps).

    CPU tensors run wide_newton_solve_reference. CUDA tensors launch the
    wide kernel on the current stream, or raise ValueError where it does
    not take the call (wide_unsupported_reason). Each launch adds one to
    ``wide_newton_solve.launches``."""
    tensors = (embeddings0, embeddings_other, scalings, scalings_other,
               aux_mat)
    if all(t.device.type == "cpu" for t in tensors):
        return wide_newton_solve_reference(
            embeddings0, embeddings_other, scalings, scalings_other,
            variance, aux_mat, max_iter, xtol_total)
    reason = wide_unsupported_reason(embeddings0, embeddings_other, scalings,
                                     scalings_other, variance, aux_mat,
                                     max_iter)
    if reason is not None:
        raise ValueError(f"wide_newton_solve cannot launch: {reason}")
    return solve_wide_in_kernel(embeddings0, embeddings_other, scalings,
                                scalings_other, variance, aux_mat, max_iter,
                                xtol_total)


wide_newton_solve.launches = 0
