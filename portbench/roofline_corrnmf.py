"""The least time an H100 could take for the joint EM cycles of a
multimodal CorrNMF fit (reference/mmcorrnmf.py's statement), frozen so
that the yardstick stays fixed whatever the program becomes.

Peaks (H100 SXM, 700 W): 67 TFLOP/s float32 outside the tensor cores and
3.35 TB/s of device memory (NVIDIA's data sheet); exponentials and
logarithms at the special function units' rate, 16 results a clock per SM
(CUDA C++ Programming Guide, throughput of the native arithmetic
instructions, compute capability 9.0: exp2f, __log2f) on 132 SMs at the
1,980 MHz boost clock, 4.18e12 a second. The bound is the largest of the
three times.
"""

from __future__ import annotations

F32_PEAK = 67e12            # float32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12          # device memory bytes/s
SFU_RATE = 16 * 132 * 1.98e9  # exponentials and logarithms a second
CANDIDATES = 41             # Armijo halvings evaluated a Newton step


def newton_step(rows: int, others: int, m: int):
    """(FLOP, transcendentals) of one damped Newton step of `rows`
    embeddings against `others`: the rates (a product, the offsets and an
    exponential per pair), the gradient, the Hessian's rank-one sum, the
    m x m solve, and the 41 candidates' products, offsets, exponentials,
    sums and quadratic terms."""
    pairs = rows * others
    flops = pairs * (2 * m + 1          # <b, o> and the offset
                     + 2 * m            # gradient
                     + m + 2 * m * m    # Hessian
                     + 1                # rate sum
                     + CANDIDATES * (2 * m + 2))
    flops += rows * (m ** 3 // 3 + 2 * m * m + CANDIDATES * 4 * m)
    return flops, pairs * (1 + CANDIDATES)


def cycle_work(D: int, Vs, Ks, m: int):
    """(FLOP, transcendentals, bytes) of one joint cycle of one lane
    without its Newton steps: per modality the sample scalings, the
    exposures, aux (two products over V and a division), the signature
    scalings and the signature update (its products again); bytes: the
    sample-side leaves and exposures written once (X is counted once a
    cycle for every lane by cycles_bound)."""
    flops = trans = 0
    n_bytes = 4 * 2 * D * m
    for V, K in zip(Vs, Ks):
        flops += 3 * (2 * K * D * m + K * D)     # scalings, exposures
        flops += 2 * (4 * D * K * V + D * V)     # aux, the W numerator
        flops += K * D + 2 * K * V
        trans += 3 * K * D + 2 * D
        n_bytes += 4 * (D * K + 2 * D + 2 * K * V)
    return flops, trans, n_bytes


def objective_work(D: int, Vs, Ks):
    """(FLOP, transcendentals) of one ELBO: per modality the rates E S,
    a logarithm and a log-gamma per count."""
    flops = sum(2 * D * K * V + 3 * D * V for V, K in zip(Vs, Ks))
    return flops, sum(2 * D * V for V in Vs)


def cycles_bound_s(D: int, Vs, Ks, m: int, lanes: int, cycles: int,
                   signature_steps: int, sample_steps: int,
                   evaluations: int) -> float:
    """Seconds of the least time for `cycles` joint cycles of each of
    `lanes` lanes (cycles a lane), with `signature_steps` signature-side
    Newton steps run over all lanes (each counted at the smaller
    modality's rows, so the bound stays a least one) and `sample_steps`
    sample-side ones, and `evaluations` ELBOs of every lane."""
    flops, trans, n_bytes = cycle_work(D, Vs, Ks, m)
    flops, trans = flops * lanes * cycles, trans * lanes * cycles
    n_bytes = n_bytes * lanes * cycles + 4 * D * sum(Vs) * cycles
    f, t = newton_step(min(Ks), D, m)
    flops, trans = flops + f * lanes * signature_steps, \
        trans + t * lanes * signature_steps
    f, t = newton_step(D, sum(Ks), m)
    flops, trans = flops + f * lanes * sample_steps, \
        trans + t * lanes * sample_steps
    f, t = objective_work(D, Vs, Ks)
    flops, trans = flops + f * lanes * evaluations, \
        trans + t * lanes * evaluations
    return max(flops / F32_PEAK, trans / SFU_RATE, n_bytes / HBM_RATE)
