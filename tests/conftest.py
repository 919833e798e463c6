import os
import sys

# Make src/ importable without installation.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax

# DTW decision-equivalence tests compare against float64 NumPy oracles;
# model code pins its own dtypes explicitly, so this only affects the
# default dtype of Python-float conversions in tests.
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips where none is present)")
