"""Hillclimb measurement harness: trace one cell with optional experimental
toggles and print its three roofline terms on the H100 (port of
``repro/launch/perf_cell.py``; compare against ``results/dryrun_torch/``).

  PYTHONPATH=src python -m repro_torch.launch.perf_cell --arch qwen2-72b \\
      --shape train_4k [--hints] [--multipod] [--tag exp1]

The cell is traced as ``launch.dryrun`` traces it (a fake world, fake
tensors, ``roofline.op_stats.OpCounter``); ``--hints`` turns the
activation anchors on. The terms divide the per-device counts by one
NVIDIA H100 SXM5's rates at 700 W (``launch.mesh``): dot FLOPs by the
bf16 tensor-core peak, memory bytes by HBM3's rate, collective bytes by
a card's NVLink rate within a node of 8 and by its NIC's for a group
that spans nodes (``op_stats`` tells them apart). Each term is the time
at those peak rates with nothing overlapped: a lower bound on that
part's time.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.launch.mesh import (
    H100_HBM_BW,
    H100_NIC_BW,
    H100_NVLINK_BW,
    H100_PEAK_BF16_FLOPS,
)


def terms(stats: dict) -> dict:
    """The three roofline terms (seconds) of ``op_stats`` counts: the
    collective bytes of groups within a node over NVLink, those of groups
    that span nodes over the NIC."""
    cross = stats["collective_cross_node"]
    return {
        "compute_s": stats["dot_flops"] / H100_PEAK_BF16_FLOPS,
        "memory_s": stats["mem_bytes"] / H100_HBM_BW,
        "collective_s": ((stats["collective_total"] - cross) / H100_NVLINK_BW
                         + cross / H100_NIC_BW),
    }


def measure(arch: str, shape_name: str, use_hints: bool,
            multi_pod: bool = False) -> dict:
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import build

    t0 = time.time()
    with dryrun.world_mesh(multi_pod) as mesh:
        res = dryrun.trace_step(build(ARCHS[arch]), SHAPES[shape_name], mesh,
                                anchors=use_hints)
    st = res["hlo_stats"]
    return {
        **terms(st),
        "dot_flops": st["dot_flops"],
        "mem_bytes": st["mem_bytes"],
        "collective_bytes": st["collective_bytes"],
        "trace_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--hints", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    out = measure(args.arch, args.shape, args.hints, args.multipod)
    label = f"{args.arch}/{args.shape}" + (" +hints" if args.hints else " baseline")
    if args.tag:
        label += f" [{args.tag}]"
    print(f"{label}: compute={out['compute_s']:.2f}s memory={out['memory_s']:.2f}s "
          f"collective={out['collective_s']:.2f}s (trace {out['trace_s']}s)")
    print(json.dumps({k: v for k, v in out.items() if k != "collective_bytes"}))
    print("coll mix:", {k: f"{v:.2e}" for k, v in out["collective_bytes"].items()})


if __name__ == "__main__":
    main()
