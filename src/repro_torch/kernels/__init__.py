"""Hand-written CUDA C++ kernels for the paper's compute hot spots (port of
``repro.kernels``), one for each ``pl.pallas_call`` of ``repro``
(``csrc/``: kernels A-E, built by ``nvcc`` at first use).

``ops.py`` holds the wrappers: on a CUDA tensor each launches its kernel,
on a CPU tensor it runs the kernel's plain PyTorch version
(``dtw_band.py``, ``lb_keogh.py``). ``dtw_ea_multi`` is the multi-query
slab round, ``dtw_ea`` its Q = 1 form, ``dtw_ea_persistent`` the
one-launch-per-search sweep and ``lb_keogh_all_windows`` the cascade.
"""
from repro_torch.kernels.ops import (
    dtw_ea,
    dtw_ea_multi,
    dtw_ea_persistent,
    lb_keogh_all_windows,
)

__all__ = ["dtw_ea", "dtw_ea_multi", "dtw_ea_persistent", "lb_keogh_all_windows"]
