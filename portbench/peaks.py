"""The yardstick's table of peaks and the least time of the work the
traffic hands the device.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
HBM at 3.35 TB/s; 32-bit integer instructions at 33.4 T a second (132 SMs
x 128 a clock x 1.98 GHz: four schedulers an SM, each issuing a 32-lane
instruction a clock, fed from the FMA and ALU pipes).

Per-row costs of the port's kernels (a row is one message's timestamp),
each input byte read once and each output byte written once:

- H, the murmur3 hash of a timestamp: 253 integer instructions a hashed
  row, counted in the kernel's SASS for one row;
- X, the segmented XOR scan: 9 B a row;
- a sort's keys: 8 B a key, read once and written once.

The relay's device leg hashes every pushed row (H), sorts it by (owner,
minute) and folds each minute with X. Each kernel's least time is the
larger of its operations over the operation peak and its bytes over the
byte peak; the leg's least time is their sum.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.4e12

H_OPS_PER_ROW = 253
H_BYTES_PER_ROW = 20  # 16 B of key columns in, a 4-byte hash out
X_BYTES_PER_ROW = 9
SORT_KEY_BYTES = 8


def kernel_least_s(ops: float = 0.0, nbytes: float = 0.0) -> float:
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def relay_leg_least_s(rows: int) -> dict:
    """The least time of the relay's device leg over `rows` pushed rows, by
    kernel, and which bound binds each."""
    work = {"H": (rows * H_OPS_PER_ROW, rows * H_BYTES_PER_ROW),
            "sort": (0, rows * 2 * SORT_KEY_BYTES),
            "X": (0, rows * X_BYTES_PER_ROW)}
    parts = {k: (kernel_least_s(ops, nbytes), "operations" if ops / INT32_OPS_PER_S > nbytes / HBM_BYTES_PER_S
                 else "bytes") for k, (ops, nbytes) in work.items()}
    return {"total_s": sum(s for s, _ in parts.values()), "parts": parts}
