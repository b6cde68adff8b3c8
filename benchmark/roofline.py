"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit) and the front-end kernel's bound, frozen copies of chip_smoke.py's
HBM_BYTES_PER_S, INT_OPS_PER_S and front_bound_ms."""

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12  # the float32 rate outside the tensor cores, same sheet


def front_bytes_ops(B: int, L: int, k: int, m: int) -> tuple:
    """Bytes and integer operations of one front-end launch: each code read
    once and each output written once (best_v, best_o 4 bytes, bad 1, NW
    q-words 4 each per window); 6 operations per m-mer (roll and hash), 3
    per candidate of the minimum, 3 per q-word, 2 for bad."""
    W, NW = L - k + 1, (2 * k + 31) // 32
    nbytes = B * L + B * W * (9 + 4 * NW)
    ops = B * (L - m + 1) * 6 + B * W * (3 * (k - m) + 3 * NW + 2)
    return nbytes, ops


def front_bound_ms(B: int, L: int, k: int, m: int) -> tuple:
    """(bound in ms, what binds) of one front-end launch."""
    nbytes, ops = front_bytes_ops(B, L, k, m)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
