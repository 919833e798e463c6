"""Three-term roofline analysis from the dry-run artifacts, on the H100
(port of ``repro/roofline/analysis.py``).

Per (arch x shape x mesh) cell of ``results/dryrun_torch/``:
    compute term    = per-device dot FLOPs        / 989 TFLOP/s (bf16 tensor cores)
    memory term     = per-device HBM bytes        / 3.35 TB/s (HBM3)
    collective term = per-device collective bytes / 450 GB/s (NVLink 4, a
                      card's 18 links a direction) for a group within
                      a node of 8 cards, / 50 GB/s (a card's 400 Gb/s
                      NIC) for a group that spans nodes

The rates are one NVIDIA H100 SXM5 80 GB's at its 700 W power limit
(``launch.mesh``); a card set lower runs slower. Each term is the time at
peak rate with nothing overlapped, a lower bound on that part's time. On
the production meshes every group spans nodes (the 16-card "model" axis
covers two, the others stride across them). The numerators are
``roofline.op_stats``'s per-device counts of one step of the eager port
(``launch.dryrun``), every loop trip counted; its memory bytes count each
op's operands and results, with no fusion.

MODEL_FLOPS is the analytic useful work: 6·N·D for training (N = active
params for MoE), 2·N·D for prefill/decode forward passes. The ratio
MODEL_FLOPS / counted FLOPs exposes remat, redundancy and padding, and
the roofline fraction (useful-compute time / dominant-term time) is the
score a perfect implementation would push to 1.0.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.mesh import H100_PEAK_BF16_FLOPS
from repro_torch.launch.perf_cell import terms as h100_terms

RESULTS_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"
)


def param_counts(cfg) -> tuple[float, float]:
    """(total, active) parameter counts, analytically from the config."""
    d, v = cfg.d_model, cfg.vocab
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * d
        h = d_inner // cfg.ssm_head_dim
        per_layer = (
            d * (2 * d_inner + 2 * cfg.ssm_state + h)
            + cfg.conv_width * (d_inner + 2 * cfg.ssm_state)
            + d_inner * d
            + 3 * h + d_inner + d
        )
        total = embed + cfg.n_layers * per_layer
        return total, total

    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.qkv_bias:
        attn += cfg.q_dim + 2 * cfg.kv_dim
    if cfg.is_moe:
        ffe = cfg.moe_d_ff or cfg.d_ff
        moe_total = cfg.n_experts * 3 * d * ffe + d * cfg.n_experts
        moe_active = (cfg.top_k) * 3 * d * ffe + d * cfg.n_experts
        shared = cfg.n_shared_experts * 3 * d * ffe
        ffn_total = moe_total + shared
        ffn_active = moe_active + shared
    else:
        ffn_total = ffn_active = 3 * d * cfg.d_ff

    if cfg.family == "hybrid":
        pattern = cfg.block_pattern or ("rec", "rec", "attn")
        w = cfg.lru_width or d
        rec = 2 * d * w + cfg.conv_width * w + 2 * w * w + w + w * d
        n_rec = sum(1 for i in range(cfg.n_layers) if pattern[i % len(pattern)] == "rec")
        n_attn = cfg.n_layers - n_rec
        total = embed + n_rec * (rec + ffn_total) + n_attn * (attn + ffn_total)
        return total, total

    layers = cfg.n_layers * (attn + ffn_total)
    layers_active = cfg.n_layers * (attn + ffn_active)
    if cfg.family == "audio":
        enc = (cfg.n_enc_layers or cfg.n_layers) * (attn + ffn_total)
        cross = cfg.n_layers * (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d)
        layers += enc + cross
        layers_active += enc + cross
    total = embed + layers
    return total, embed + layers_active


def model_flops(cfg, shape) -> float:
    """Global useful FLOPs for one step of this cell."""
    total, active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence; embedding table isn't multiplied
    return 2.0 * active * shape.global_batch


def analyze_cell(res: dict) -> dict | None:
    if res.get("status") != "ok":
        return None
    cfg = ARCHS[res["arch"]]
    shape = SHAPES[res["shape"]]
    chips = 1
    for v in res["mesh"].values():
        chips *= v
    st = res["hlo_stats"]
    terms = {k[:-2]: v for k, v in h100_terms(st).items()}
    compute_s, memory_s, coll_s = (terms["compute"], terms["memory"],
                                   terms["collective"])
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful_s = (mf / chips) / H100_PEAK_BF16_FLOPS
    bound_s = max(terms.values())
    total_flops = st["dot_flops"] * chips
    return {
        "arch": res["arch"],
        "shape": res["shape"],
        "mesh": "2x16x16" if res["multi_pod"] else "16x16",
        "chips": chips,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": total_flops,
        "useful_ratio": mf / total_flops if total_flops else 0.0,
        "roofline_fraction": useful_s / bound_s if bound_s else 0.0,
        "param_bytes_per_device": res.get("param_bytes_per_device"),
        "state_bytes_per_device": res.get("state_bytes_per_device"),
        "cache_bytes_per_device": res.get("cache_bytes_per_device"),
        "fits_one_card": res.get("fits_one_card"),
        "collective_mix": st["collective_bytes"],
    }


FIX_NOTES = {
    "compute": "keep the tensor cores busy: bigger products, fewer remat recomputes, split replicated heads",
    "memory": "cut HBM3 traffic: fuse elementwise ops into kernels, bf16 intermediates, fewer reshards",
    "collective": "cut NVLink/NIC bytes: overlap with compute, hierarchical reduce, flash-decode the KV gather",
}


def load_cells(results_dir: str = RESULTS_DIR) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            res = json.load(f)
        if res.get("arch") == "dtw-search":
            continue
        if res.get("status") == "skipped":
            rows.append({
                "arch": res["arch"], "shape": res["shape"],
                "mesh": "2x16x16" if res["multi_pod"] else "16x16",
                "skipped": res["reason"],
            })
            continue
        cell = analyze_cell(res)
        if cell:
            rows.append(cell)
    return rows


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def render_markdown(rows: list[dict], mesh_filter: str = "16x16") -> str:
    out = [
        "| arch | shape | compute | memory | collective | bound | "
        "MODEL/counted flops | roofline frac | fix |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("mesh") != mesh_filter:
            continue
        if "skipped" in r:
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | — | skip | {r['skipped']} |"
            )
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {FIX_NOTES[r['dominant']][:58]} |"
        )
    return "\n".join(out)


def main() -> None:
    rows = load_cells()
    print(render_markdown(rows, "16x16"))
    print()
    print(render_markdown(rows, "2x16x16"))


if __name__ == "__main__":
    main()
