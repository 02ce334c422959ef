"""Length-aware coverage calibration.

Reference: ``haplotyper/src/copy_number_estimation/mod.rs:20-77``
(CoverageCalibrator) — converts an observed count of reads spanning a
``gap_len`` region into the equivalent point coverage, using the read-length
distribution: a read of length L covers a specific gap of length g at
L - g + ... positions, so long gaps are spanned by proportionally fewer
reads and their raw counts must be scaled up.
"""

from __future__ import annotations

import numpy as np


class CoverageCalibrator:
    def __init__(self, lengths):
        self.lengths = np.sort(np.asarray(lengths, np.int64))
        n = len(self.lengths)
        # cum_sum[i] = sum of lengths[i:]
        self.cum_sum = np.concatenate(
            [np.cumsum(self.lengths[::-1])[::-1], [0]])
        self.mean = float(self.lengths.mean()) if n else 0.0

    def _factor(self, gap_len: int) -> float:
        """Average number of positions per read at which it spans the gap."""
        n = len(self.lengths)
        if n == 0:
            return 0.0
        idx = int(np.searchsorted(self.lengths, gap_len, side="left"))
        if idx == n and (n == 0 or self.lengths[-1] < gap_len):
            return 0.0
        return float(self.cum_sum[idx] - gap_len * (n - idx)) / n

    def calib(self, observed: float, gap_len: int) -> float:
        """Observed span count over a gap_len region -> point coverage."""
        f = self._factor(int(max(gap_len, 0)))
        if f <= 0:
            return 0.0
        return float(observed) * self.mean / f

    def prob_spanning(self, gap_len: int) -> float:
        """Probability that a random read spans a specific gap_len gap."""
        f = self._factor(int(max(gap_len, 0)))
        return f / self.mean if self.mean else 0.0
