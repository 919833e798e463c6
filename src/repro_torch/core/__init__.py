"""The paper's contribution: EAPrunedDTW and its supporting DTW stack (port
of ``repro.core``).

Public API, as ``repro.core`` exports it:
  dtw, dtw_batch, dtw_matrix    — exact DTW (closed-form row recurrence)
  ea_pruned_dtw                 — EAPrunedDTW of one pair, full-row
  ea_pruned_dtw_banded          — EAPrunedDTW, banded, batched over lanes
  ea_pruned_dtw_batch           — one query's slab round (kernel D on CUDA),
                                  scalar or per-lane ub
  ea_pruned_dtw_multi_batch     — Q queries' rounds as one (Q x K)-lane
                                  launch of kernel D, per-lane ub
  ea_pruned_dtw_persistent      — the whole best-first sweep in one launch
                                  (kernel E on CUDA)
  ea_search_round               — one slab round plus the strict argmin fold
  pruned_dtw                    — PrunedDTW baseline (row-min abandon)
  envelope, lb_keogh, lb_keogh_pair, lb_kim_fl, cascade_keogh_cumulative
                                — lower bounds
  SearchInputError, NonFiniteInputError, StreamStateError
                                — typed guard taxonomy (core.guards)

``repro``'s ``BACKENDS`` and ``resolve_backend`` have no counterpart: the
port dispatches by the device of the tensors (each ``kernels.ops`` wrapper
launches its CUDA kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors), so there is no backend to select.
"""
from repro_torch.core.guards import (
    NonFiniteInputError,
    SearchInputError,
    StreamStateError,
)
from repro_torch.core.batch import (
    ea_pruned_dtw_batch,
    ea_pruned_dtw_multi_batch,
    ea_pruned_dtw_persistent,
    ea_search_round,
)
from repro_torch.core.common import BIG
from repro_torch.core.dtw import dtw, dtw_batch, dtw_matrix
from repro_torch.core.ea_pruned_dtw import (
    EAInfo,
    ea_pruned_dtw,
    ea_pruned_dtw_banded,
)
from repro_torch.core.lower_bounds import (
    cascade_keogh_cumulative,
    envelope,
    lb_keogh,
    lb_keogh_pair,
    lb_kim_fl,
)
from repro_torch.core.pruned_dtw import pruned_dtw

__all__ = [
    "BIG",
    "EAInfo",
    "cascade_keogh_cumulative",
    "dtw",
    "dtw_batch",
    "dtw_matrix",
    "ea_pruned_dtw",
    "ea_pruned_dtw_banded",
    "ea_pruned_dtw_batch",
    "ea_pruned_dtw_multi_batch",
    "ea_pruned_dtw_persistent",
    "ea_search_round",
    "envelope",
    "lb_keogh",
    "lb_keogh_pair",
    "lb_kim_fl",
    "NonFiniteInputError",
    "SearchInputError",
    "StreamStateError",
    "pruned_dtw",
]
