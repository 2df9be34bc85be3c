"""Sparse-matrix panel streaming: blocked CSR -> dense tiles.

The in-memory solvers take dense X; the plan for the 100M-nonzero
configs (SURVEY §7.9) is blocked densification — column panels of V are
densified on the host (native C++ panelizer, multithreaded; scipy
fallback) and staged to the device, where they ride the ring/psum
schedules like any dense panel.
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator

import numpy as np

from ..native import get_panelizer


def _as_csr(matrix):
    import scipy.sparse as sp

    csr = matrix.tocsr() if not sp.isspmatrix_csr(matrix) else matrix
    csr.sort_indices()
    return csr


class PanelStream:
    """Iterate dense (row_block x col_panel) tiles of a sparse CSR matrix.

    Args:
      matrix: scipy sparse matrix (any format; converted to CSR).
      row_block: tile height (rows per panel), clamped to m.
      col_panel: tile width (columns per panel), clamped to n.
      n_threads: host threads for the native densifier.
    """

    def __init__(self, matrix, row_block: int = 4096, col_panel: int = 4096,
                 n_threads: int | None = None):
        self.csr = _as_csr(matrix)
        self.m, self.n = self.csr.shape
        self.row_block = min(row_block, self.m)
        self.col_panel = min(col_panel, self.n)
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self._lib = get_panelizer()
        self._indptr = np.ascontiguousarray(self.csr.indptr, dtype=np.int64)
        self._indices = np.ascontiguousarray(self.csr.indices, dtype=np.int32)
        self._data = np.ascontiguousarray(self.csr.data, dtype=np.float32)
        # densification counter: lets tests assert the streaming solvers
        # read each block exactly once per pass (no redundant densifies)
        self.densify_count = 0

    @property
    def grid(self) -> tuple[int, int]:
        rb = -(-self.m // self.row_block)
        cb = -(-self.n // self.col_panel)
        return rb, cb

    def panel(self, i: int, j: int, out: np.ndarray | None = None) -> np.ndarray:
        """Densify tile (i, j); edge tiles are zero-padded to full size."""
        row0 = i * self.row_block
        col0 = j * self.col_panel
        rows = min(self.row_block, self.m - row0)
        cols = min(self.col_panel, self.n - col0)
        self.densify_count += 1
        if out is None:
            out = np.zeros((self.row_block, self.col_panel), dtype=np.float32)
        else:
            out[:] = 0.0

        if self._lib is not None and cols == self.col_panel:
            self._lib.csr_panel_f32(
                self._indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self._data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                row0, rows, col0, cols,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.n_threads,
            )
        else:
            sub = self.csr[row0:row0 + rows, col0:col0 + cols].toarray()
            out[:rows, :cols] = sub
        return out

    def panel_bf16(self, i: int, j: int) -> np.ndarray:
        """Densify tile (i, j) directly to bfloat16 (RNE).

        The transfer-compression path for transfer-bound streaming —
        halves host->device bytes; device-side accumulation stays f32.
        Native path converts during densification (no extra host pass);
        the fallback densifies f32 then casts once."""
        import ml_dtypes

        row0 = i * self.row_block
        col0 = j * self.col_panel
        rows = min(self.row_block, self.m - row0)
        cols = min(self.col_panel, self.n - col0)
        if self._lib is not None and cols == self.col_panel and hasattr(
                self._lib, "csr_panel_bf16"):
            self.densify_count += 1
            out = np.zeros((self.row_block, self.col_panel),
                           dtype=ml_dtypes.bfloat16)
            self._lib.csr_panel_bf16(
                self._indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self._data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                row0, rows, col0, cols,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                self.n_threads,
            )
            return out
        return self.panel(i, j).astype(ml_dtypes.bfloat16)

    def panel_nnz(self, i: int, j: int) -> int:
        """Nonzero count of a tile (lets schedulers skip empty panels)."""
        row0 = i * self.row_block
        col0 = j * self.col_panel
        rows = min(self.row_block, self.m - row0)
        cols = min(self.col_panel, self.n - col0)
        if self._lib is not None:
            return int(self._lib.csr_panel_nnz(
                self._indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                row0, rows, col0, cols,
            ))
        return int(self.csr[row0:row0 + rows, col0:col0 + cols].nnz)

    def __iter__(self) -> Iterator[tuple[int, int, np.ndarray]]:
        """Iterate (i, j, panel) tiles.

        NOTE: yields views of two rotating host buffers so densification
        can overlap a device transfer — the caller must consume (copy or
        synchronously transfer) each panel before advancing the iterator
        twice, or take its own copy.  For random access without aliasing
        use :meth:`panel` with ``out=None``.
        """
        rb, cb = self.grid
        bufs = [
            np.zeros((self.row_block, self.col_panel), dtype=np.float32)
            for _ in range(2)
        ]
        s = 0
        for i in range(rb):
            for j in range(cb):
                yield i, j, self.panel(i, j, out=bufs[s])
                s ^= 1


def densify(matrix) -> np.ndarray:
    """Whole-matrix densification through the panel path (convenience)."""
    stream = PanelStream(matrix)
    out = np.zeros((stream.m, stream.n), dtype=np.float32)
    rb, cb = stream.grid
    for i, j, panel in stream:
        r0, c0 = i * stream.row_block, j * stream.col_panel
        rows = min(stream.row_block, stream.m - r0)
        cols = min(stream.col_panel, stream.n - c0)
        out[r0:r0 + rows, c0:c0 + cols] = panel[:rows, :cols]
    return out
