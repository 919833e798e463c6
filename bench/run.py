"""Run one cell of the benchmark on the card and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (a
``torch.profiler`` trace of the window). The last line of standard output
is one JSON object; the last lines of standard error are the numbers the
comparison held to their limits. Exits with 2, and prints no result, when
no card (or too few) is present, and with 3 when JAX or the JAX package
was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    # Every cache of a build or a compile stays inside the checkout, at a
    # fixed path (the port's kernels build into ``build/repro_torch_kernels``).
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from bench.harness import manifest, runner

    cell = manifest.resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA device(s), "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, lines = runner.run_cell(ROOT, args.workload, args.seed,
                                    args.seconds, bool(args.trace), "cuda", T0)
    # Once the window and the reference are done: a module loaded at any
    # point stays in ``sys.modules``.
    found = runner.jax_modules()
    if found:
        print(f"no result: JAX modules loaded by the run: {found}",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    code = main()
    # No exit handler may print after the result.
    os._exit(code)
