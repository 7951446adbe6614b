"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit)
and the work of the sketch kernels, counted from what a map's inputs need
whatever the implementation does.

A roofline share is the least time the work could take on the card (the
larger of its bytes over the memory rate and its operations over the
fp32 and special-function rates) over the kernel's measured time."""
from __future__ import annotations

BYTES_PER_S = 3.35e12          # HBM3
FP32_PER_S = 67e12             # fp32 outside the tensor cores
# special-function results (exp, log, reciprocal): 16 a clock an SM (CUDA
# C Programming Guide, compute capability 9.0) on 132 SMs at 1.98 GHz
SFU_PER_S = 132 * 16 * 1.98e9

KEY_BYTES = 8                  # a 64-bit cell key
VALUE_BYTES = 4                # a float32 count or estimate
CELL_BYTES = 4                 # a float32 table cell


def bound_s(nbytes: float, flops: float = 0.0, sfu: float = 0.0) -> float:
    return max(nbytes / BYTES_PER_S, flops / FP32_PER_S, sfu / SFU_PER_S)


def k7_bytes(cells: int, table_cells: int) -> float:
    """K7 ``sketch_update_table`` on a map's points: each distinct
    occupied cell's key and count read once; each table cell its R
    hashes touch read and written once."""
    return cells * (KEY_BYTES + VALUE_BYTES) + table_cells * 2 * CELL_BYTES


def k8_bytes(queries: int, pool_cells: int) -> float:
    """K8 ``sketch_estimate_table`` on the candidate pool: each key read
    once and its estimate written once; each table cell the pool's R
    hashes touch read once."""
    return queries * (KEY_BYTES + VALUE_BYTES) + pool_cells * CELL_BYTES


def share_pct(bound: float, measured_s: float) -> float:
    return 100.0 * bound / measured_s
