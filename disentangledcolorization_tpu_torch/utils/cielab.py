"""CIELAB ab-gamut quantization (313 bins) as numpy lookup tables.

Counterpart of ``disentangledcolorization_tpu/utils/cielab.py``. The tables are
built once in numpy; ``ops/colorlabel.py`` moves them to the device. The data
files ``gamut_pts.npy`` (313x2 ab bin centers) and ``gamut_probs.npy`` (the
313-way empirical prior) are byte-for-byte copies of the JAX package's.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))

# 10-wide ab bins spanning [-115, 115): 23 bins per axis, 313 of them in gamut.
AB_BINSIZE = 10
AB_LO = -110 - AB_BINSIZE // 2
AB_HI = 110 + AB_BINSIZE // 2
L_MEAN = 50.0
L_NORM = 50.0
AB_NORM = 110.0
NUM_BINS = 313


@functools.lru_cache(maxsize=1)
def q_to_ab() -> np.ndarray:
    """(313, 2) float32 bin-center ab values in real units, in bin-index order."""
    points = np.load(os.path.join(_HERE, "gamut_pts.npy")).astype(np.float32)
    assert points.shape == (NUM_BINS, 2)
    a = np.arange(AB_LO, AB_HI, AB_BINSIZE, dtype=np.float32)
    b_, a_ = np.meshgrid(a, a)
    grid = np.dstack((a_, b_))  # (23, 23, 2): grid[i, j] = (a[i], b[j])
    mask = np.zeros(grid.shape[:-1], dtype=bool)
    mask[np.digitize(points[:, 0], a) - 1, np.digitize(points[:, 1], a) - 1] = True
    # bin centers: grid corner + half a bin
    return (grid[mask] + AB_BINSIZE / 2).astype(np.float32)
