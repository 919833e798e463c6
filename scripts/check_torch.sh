#!/usr/bin/env bash
# Local gate of the PyTorch/CUDA port on the CPU: the import lint (the port
# imports neither jax nor repro), the feature-retrieval example (Mamba2
# encoder + EAPrunedDTW), a brief run of the LM training example and the
# port's tests, which hold it against repro on the same inputs.
# Usage: scripts/check_torch.sh [extra pytest args]
# The kernels themselves are checked on a card by chip_smoke.py.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

echo "== port import lint =="
python scripts/lint_port.py

echo "== example: feature retrieval (CPU) =="
python examples/feature_retrieval_torch.py --device cpu

echo "== example: LM training, briefly (CPU) =="
ckpt="$(mktemp -d)"
python examples/train_lm_torch.py --device cpu --steps 12 --batch 2 \
    --seq 32 --depth 1 --ckpt "$ckpt"
rm -rf "$ckpt"

echo "== port tests (CPU) =="
python -m pytest -q tests/test_torch_*.py "$@"

echo "== check_torch OK =="
