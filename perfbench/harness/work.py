"""The yardstick's work counts and the chip's peaks.

A kernel's least time is the larger of its bytes at the HBM bandwidth and
its operations at the float32 rate of one H100 SXM (NVIDIA's data sheet, no
sparsity).  Bytes count each input read once and each output written once:
only the non-zero walk slots (value and column, 4 + 4 bytes) and the rows
of the dense operand that they touch.  Every count here is taken from the
problem (the reference's trace, the sizes), never from the kernels that ran
or their launch parameters.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SLOT_BYTES = 8            # a non-zero slot as a kernel reads it: value, column
TRACE_SLOT_BYTES = 12     # a trace slot as stored: column, load, length
F32 = 4


def least_s(nbytes: float, flops: float) -> float:
    """The least time of ``nbytes`` moved and ``flops`` computed."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def spmv(nnz: int, touched_rows: int, out_rows: int, r: int):
    """(bytes, flops) of y = Φu: ``nnz`` slots, ``touched_rows`` rows of u
    [·, r] that they gather, ``out_rows`` rows of y written."""
    return (SLOT_BYTES * nnz + F32 * r * (touched_rows + out_rows),
            2 * nnz * r)


def khat(nnz_cols: int, in_rows: int, nnz_rows: int, hits_rows: int,
         out_rows: int, r: int, shared: bool):
    """(bytes, flops) of y = Φ_rows(Φ_colsᵀv): Φ_cols' ``nnz_cols`` slots
    scatter v [in_rows, r]; Φ_rows' ``nnz_rows`` slots are read, of which
    ``hits_rows`` land on a column that Φ_cols touches and gather from it.
    ``shared``: Φ_rows is Φ_cols (K̂_xx), read once."""
    payload = nnz_cols + (0 if shared else nnz_rows)
    return (SLOT_BYTES * payload + F32 * r * (in_rows + out_rows),
            2 * r * (nnz_cols + hits_rows))
