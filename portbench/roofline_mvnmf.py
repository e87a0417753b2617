"""The least time an H100 could take for the minimum-volume NMF work of a
de novo extraction (reference/mvnmf.py's statement), frozen so that the
yardstick stays fixed whatever the program becomes.

Peaks as roofline.py and roofline_corrnmf.py state them: 67 TFLOP/s
float32 outside the tensor cores, logarithms at the special function
units' 4.18e12 a second, 3.35 TB/s of device memory; the bound is the
largest of the three. Bytes follow roofline.block_bound's rule: a lane's
X is read once a block of conv_test_freq iterations, and again at each
iteration after the first only where its X with its W and H exceed what
the card holds on chip; W and H are read and written once a block.
"""

from __future__ import annotations

from .roofline import BLOCK, ON_CHIP_BYTES
from .roofline_corrnmf import F32_PEAK, HBM_RATE, SFU_RATE


def objective_work(V: int, D: int, K: int):
    """(FLOP, logarithms) of one penalized objective given its WH: the KL
    terms (a division, a logarithm's product, two sums) and their sum,
    the K x K Gram, its Cholesky factor and its K logarithms."""
    return (5 * V * D + 2 * V * K * K + K ** 3 // 3 + K,
            V * D + K)


def iteration_work(V: int, D: int, K: int):
    """(FLOP, logarithms) of one iteration of one lane without its
    trials: the H update (WH, the ratio, W^T aux, the product), the W
    step (WH at the new H, the ratio, its product with H^T, H's row sums,
    the Gram, its factor and inverse, W Y- and W |Y|, about 15 operations
    an entry of W) and the objective the search starts from, which shares
    the W step's WH."""
    flops = 4 * V * D * K + V * D + K * D          # H update
    flops += 4 * V * D * K + V * D + K * D         # the W step's sums
    flops += 2 * V * K * K + K ** 3 + 4 * V * K * K + 15 * V * K
    f, logs = objective_work(V, D, K)
    return flops + f, logs


def trial_work(V: int, D: int, K: int):
    """(FLOP, logarithms) of one trial: the interpolated W, its column
    sums and the renormalization of W and H with their floors, WH and the
    penalized objective."""
    f, logs = objective_work(V, D, K)
    return 4 * V * K + 3 * K * D + 2 * V * D * K + f, logs


def lane_bound_s(V: int, D: int, K: int, iterations: int,
                 trials: int) -> float:
    """Seconds of the least time for one lane of rank K: `iterations`
    iterations and `trials` trials, X (V, D) its own."""
    f_it, l_it = iteration_work(V, D, K)
    f_tr, l_tr = trial_work(V, D, K)
    flops = iterations * f_it + trials * f_tr
    logs = iterations * l_it + trials * l_tr
    x_one = 4 * V * D
    over = min(x_one, max(0.0, x_one + 4 * (V * K + K * D) - ON_CHIP_BYTES))
    blocks = -(-int(iterations) // BLOCK)
    n_bytes = blocks * (x_one + (BLOCK - 1) * over
                        + 4 * (2 * V * K + 2 * K * D))
    return max(flops / F32_PEAK, logs / SFU_RATE, n_bytes / HBM_RATE)


def lanes_bound_s(V: int, D: int, lanes) -> float:
    """Seconds of the least time for lanes [(K, iterations), ...], each
    its own fit of its own X at its own rank, one trial an iteration (the
    least any search takes: how many more a lane ran is not known lane by
    lane, so none is charged). A padded rank or a lane after its stop is
    never charged."""
    return sum(lane_bound_s(V, D, int(K), int(it), int(it))
               for K, it in lanes)
