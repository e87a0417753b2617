"""The least time an H100 could take for the MU work a fit did.

Frozen copy of chip_smoke.py:241-245 (the peaks) and :351-373
(``block_bound``, corrected in review of its PR 11 run), so that the
yardstick stays fixed whatever the program's own copy becomes.
"""

from __future__ import annotations

F32_PEAK = 67e12            # H100 SXM float32 FLOP/s outside tensor cores
HBM_RATE = 3.35e12          # H100 SXM device memory bytes/s
ON_CHIP_BYTES = 50e6 + 132 * 232448  # H100 L2 and every SM's shared memory
BLOCK = 10                  # MU steps in one block (conv_test_freq)


def block_bound(R: int, V: int, K: int, D: int, steps: int,
                per_lane_x: bool = False):
    """(ms, "operations" or "bytes"): the least time an H100 could take
    for `steps` joint updates of R lanes. Per step and lane 6*V*D*K FLOP of
    the three depth-K contractions, V*D divisions, ~4*V*K (W') and 2*K*D
    (H') elementwise operations, at the 67 TFLOP/s float32 peak outside
    the tensor cores; bytes: X (one, or one per lane) read once, W and H
    read and written once, at 3.35 TB/s. The lanes are independent fits,
    so a schedule may run them one after another: only where one X with one
    lane's W and H exceeds what the card holds on chip (L2 and every SM's
    shared memory) does each step after the first reread X, and then only
    the bytes above that capacity."""
    flops = steps * R * (6 * V * D * K + V * D + 4 * V * K + 2 * K * D)
    x_one = 4 * V * D
    over = min(x_one, max(0.0, x_one + 4 * (V * K + K * D) - ON_CHIP_BYTES))
    x_bytes = (R if per_lane_x else 1) * (x_one + (steps - 1) * over)
    n_bytes = x_bytes + 4 * (2 * R * V * K + 2 * R * K * D)
    ops_ms, bytes_ms = 1e3 * flops / F32_PEAK, 1e3 * n_bytes / HBM_RATE
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def lanes_bound_s(V: int, D: int, lanes, per_lane_x: bool) -> float:
    """Seconds of the least time for lanes [(K, iterations), ...], each
    summed over its own 10-step blocks: the work these inputs need, not
    the frozen lanes a lockstep batch carries."""
    total_ms = 0.0
    for K, iterations in lanes:
        blocks = int(iterations) // BLOCK
        total_ms += blocks * block_bound(1, V, int(K), D, BLOCK,
                                         per_lane_x)[0]
    return total_ms / 1e3
