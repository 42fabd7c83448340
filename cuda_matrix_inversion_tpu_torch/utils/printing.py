"""Debug pretty-printers for matrices and batches.

Reference counterpart: ``printMatrix`` / ``printMatrixList``
(``src/helper.cu:74-99``) — column-major pretty printers.  Ours take
``(m, n)`` / ``(batch, m, n)`` ndarrays.  A copy of
``cuda_matrix_inversion_tpu/utils/printing.py``.
"""

from __future__ import annotations

import sys

import numpy as np


def print_matrix(mat: np.ndarray, file=None, fmt: str = "{: .6f}") -> None:
    file = file or sys.stdout
    mat = np.asarray(mat)
    for row in mat:
        print("\t".join(fmt.format(float(v)) for v in np.atleast_1d(row)), file=file)
    print(file=file)


def print_matrix_list(mats: np.ndarray, file=None, fmt: str = "{: .6f}") -> None:
    file = file or sys.stdout
    for k, mat in enumerate(np.asarray(mats)):
        print(f"matrix {k}:", file=file)
        print_matrix(mat, file=file, fmt=fmt)
