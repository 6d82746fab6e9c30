"""Device compute for the LETKF analysis.

* solver.py    — batched ensemble-space k-by-k solve (the hot kernel)
* neighbors.py — on-device fixed-radius neighbor search (kd-tree replacement)
* whiten.py    — local-obs assembly: QC, rejection, R-localization whitening
"""

from .solver import letkf_solve_batch, letkf_weight_factors, apply_weight_factors, tune_q

__all__ = [
    "letkf_solve_batch",
    "letkf_weight_factors",
    "apply_weight_factors",
    "tune_q",
]
