"""The port's LM serving path against ``repro``'s.

* greedy ``generate`` gives ``repro``'s tokens wherever ``repro``'s
  ``generate`` runs (the dense and MoE transformers and mamba2), on
  carried weights (the MoE's prefill drops at its default capacity), and
  each dense or mamba2 token is the argmax of the port's own
  teacher-forced forward;
* temperature sampling repeats for one generator seed (``jax.random``'s
  stream cannot be reproduced, so only greedy output is held to repro);
* the registry's quirks, pinned in both packages: pixtral (embeddings
  in), recurrentgemma (no ``prefill``; the cache is built before the
  check) and whisper (``prefill`` reads ``embeds`` and returns only the
  cache) fail in ``generate`` with the same exception;
* ``python -m repro_torch.launch.serve --reduced --device cpu`` runs and
  prints ``repro``'s lines plus prefill and decode times; without a
  device and without CUDA it raises.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.serve.generate import generate as r_generate
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import generate

from lm_pairs import pair

ROOT = Path(__file__).resolve().parents[1]
GENERATES = [n for n in sorted(R_ARCHS) if ARCHS[n].family in ("dense", "moe", "ssm")]


@pytest.mark.parametrize("name", GENERATES)
def test_greedy_generate_matches_repro(name):
    pr = pair(name)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, pr.cfg.vocab, (2, 6))
    want = r_generate(pr.r_model, pr.r_params, jnp.asarray(prompt), 5)
    got = generate(pr.model, pr.params, torch.as_tensor(prompt), 5)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    if pr.cfg.is_moe:
        return  # a forward's capacity (so its drops) depends on its length
    # and each new token is the argmax of the port's own forward
    for t in range(6, 11):
        logits, _ = pr.model.forward(pr.params, tokens=got[:, :t])
        assert torch.equal(torch.argmax(logits[:, -1], -1), got[:, t]), t


def test_generate_into_a_longer_rolling_cache():
    """max_len past the window: the SWA cache rolls during generation."""
    pr = pair("h2o-danube-3-4b", sliding_window=6)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, pr.cfg.vocab, (2, 9))
    want = r_generate(pr.r_model, pr.r_params, jnp.asarray(prompt), 8, max_len=40)
    got = generate(pr.model, pr.params, torch.as_tensor(prompt), 8, max_len=40)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_temperature_sampling_repeats_for_one_seed():
    cfg = ARCHS["llama3.2-3b"].reduced()
    from repro_torch.models.registry import build

    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 5)))

    def run(seed, temperature=1.0):
        return generate(model, params, prompt, 12, temperature=temperature,
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(a[:, :5], prompt)
    # the default generator is seeded with 0
    assert torch.equal(generate(model, params, prompt, 12, temperature=1.0), run(0))
    # a temperature near 0 is greedy on these logits
    assert torch.equal(run(3, 1e-6), generate(model, params, prompt, 12))


@pytest.mark.parametrize("name,error", [("pixtral-12b", AttributeError),
                                        ("recurrentgemma-2b", ValueError),
                                        ("whisper-large-v3", KeyError)])
def test_generate_fails_where_repros_fails(name, error):
    pr = pair(name)
    prompt = np.random.default_rng(2).integers(0, pr.cfg.vocab, (2, 4))
    built = []

    def spy(model):
        init_cache = model.init_cache
        return model._replace(init_cache=lambda *a, **k: built.append(1)
                              or init_cache(*a, **k))

    with pytest.raises(error):
        r_generate(spy(pr.r_model), pr.r_params, jnp.asarray(prompt), 3)
    with pytest.raises(error):
        generate(spy(pr.model), pr.params, torch.as_tensor(prompt), 3)
    assert built == [1, 1]  # both built the cache before failing
    assert (pr.model.prefill is None) == (pr.r_model.prefill is None)


def test_serve_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mistral-nemo-12b", "--reduced", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "serving mistral-nemo-12b: 0.1M params, batch=4"
    assert lines[1].startswith("generated 32 tokens x 4 seqs in ")
    assert lines[2].startswith("sample continuation ids: [")
    assert lines[3].startswith("prefill ") and "ms a token (cpu)" in lines[3]


def test_serve_cli_refuses_an_arch_without_prefill(capsys):
    with pytest.raises(SystemExit, match="has no prefill path"):
        serve_cli.main(["--arch", "recurrentgemma-2b", "--reduced",
                        "--device", "cpu", "--new-tokens", "2"])


def test_serve_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "llama3.2-3b", "--reduced"])
