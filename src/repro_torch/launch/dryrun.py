"""Multi-pod dry-run: trace every (architecture x shape x mesh) cell on
torch's ``fake`` process group (port of ``repro/launch/dryrun.py``).

``repro`` lowers and compiles each cell's jitted step for the production
mesh on 512 host devices. The port has no compiler to ask; it runs the
step itself, as rank 0 of a fake world of 256 (``(16, 16)``) or 512
(``(2, 16, 16)``) ranks whose collectives return at once, on fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory, no arithmetic). For
each cell it:

  1. starts the fake world and builds ``make_production_mesh``'s mesh
     (on ``"cuda"`` where a card is present, else ``"cpu"``),
  2. builds the specs and meta shapes of the state, parameters and cache
     outside ``FakeTensorMode`` (the rules read meta tensors), then makes
     fake tensors and ``place``s them inside it,
  3. runs the train step (forward and backward, the optimizer's apply),
     the prefill (``forward`` for the archs without one) or one decode
     step on them under ``roofline.op_stats.OpCounter``: per-device dot
     FLOPs, memory traffic and collective bytes by kind, every loop trip
     counted. A sharding the step cannot run, or a host read of a fake
     value, fails HERE, which is the point,
  4. records the analytic per-device bytes of parameters, optimizer state
     and cache (``_sharded_bytes``, ``repro``'s arithmetic) and writes one
     JSON a cell with ``repro``'s keys under ``results/dryrun_torch/``
     (``results/dryrun_torch_opt/`` with ``--opt``; resumable).

``repro``'s ``lower_s`` + ``compile_s`` are one ``trace_s`` here;
``memory_analysis`` holds this rank's argument and output bytes (no peak
of live bytes is measured, so no ``temp_size_in_bytes``). A cell whose
per-device bytes exceed one card's 80 GB records ``"fits_one_card":
false``; that is a finding, not an error.

The search cell (``--search``) runs ``make_distributed_search`` over the
whole fake mesh at ``SEARCH_CONFIG``: rank 0 searches its own range of
windows for real on its device (kernels B and A on a card), and its
``all_reduce``s return its own values. Its rounds are those of its range
alone; the collectives are given a round.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod | --both-meshes] [--force] [--opt]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --search [--both-meshes]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed import hints
from repro_torch.distributed.sharding import (
    batch_axes,
    make_cache_specs,
    make_param_specs,
    make_state_specs,
    param_shapes,
    place,
    place_batch,
)
from repro_torch.launch.input_specs import (
    applicable,
    cache_shapes,
    decode_inputs,
    prefill_inputs,
    train_batch_specs,
)
from repro_torch.launch.mesh import (
    H100_HBM_BYTES,
    PRODUCTION_SHAPES,
    make_production_mesh,
)
from repro_torch.models.registry import build
from repro_torch.roofline.op_stats import OpCounter
from repro_torch.train.layout import get, leaves, stacks, tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
OPT_RESULTS_DIR = RESULTS_DIR + "_opt"

# Per-arch config tuning applied only in the optimized sweep, as repro's:
# kimi's 384-expert dispatch through the expert-parallel MoE with half
# the microbatches.
OPT_OVERRIDES: dict = {
    "kimi-k2-1t-a32b": {"train_4k": dict(moe_impl="ep", num_microbatches=8)},
}
DECODE_BUDGET = 14 * 2**30  # bytes a device for TP-resident decode weights
SEARCH_DATASET = "ECG"      # the search cell's reference and query
# the search kernels, whose launches the search cell reports (each
# wrapper counts the launches it makes on the card)
KERNELS = ("dtw_ea_multi_fused", "lb_keogh_all_windows",
           "dtw_ea_persistent_fused", "dtw_ea_multi", "dtw_ea_persistent")


def _bytes_of(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))


def _sharded_bytes(shapes, specs, mesh) -> int:
    """Per-device bytes given PartitionSpecs (analytic, no allocation)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    total = 0
    for (_, leaf), (_, spec) in zip(leaves(shapes), leaves(specs)):
        shards = 1
        for entry in tuple(spec):
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                shards *= sizes[a]
        total += leaf.numel() * leaf.element_size() // max(shards, 1)
    return total


def _state_bytes(model, sshapes, sspecs, mesh) -> int:
    """``_sharded_bytes`` of the train state, as ``repro`` counts it:
    Adafactor keeps one column statistic for a stack of vectors, which
    each layer's entry of the port's state holds, so it counts once."""
    total = _sharded_bytes(sshapes, sspecs, mesh)
    if model.cfg.optimizer != "adafactor":
        return total
    params = sshapes.params
    for stack in stacks(model.cfg, params):
        if stack.stacked and get(params, stack.paths[0]).dim() == 1:
            for path in stack.paths[1:]:
                total -= _sharded_bytes(get(sshapes.opt.vc, path),
                                        get(sspecs.opt.vc, path), mesh)
    return total


def device_type() -> str:
    """The fake mesh's device: the card where one is present."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_world(world_size: int):
    """Rank 0 of a ``fake`` process group of ``world_size`` ranks, as the
    default group, destroyed on exit. A default group that is already
    running is an error: the dry-run never reuses one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "the dry-run starts its own fake process group, but a default "
            f"group ({dist.get_backend()}, {dist.get_world_size()} ranks) "
            "is already running: run the dry-run in a process of its own "
            "(python -m repro_torch.launch.dryrun)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _real_shard_math():
    """DTensor works out a strided shard's sizes and offsets (a split of
    rows inside another axis's split, as a product's strategy can leave)
    with tensor ops on the host: ``torch.arange`` and a ``.tolist()``.
    Under ``FakeTensorMode`` those tensors would be fake and the read
    would fail; that bookkeeping runs on real host tensors here."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = real
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _fake_like(tree, dev):
    """A tensor on ``dev`` for each meta leaf of ``tree``, made inside
    ``FakeTensorMode`` (so fake); ``None`` kept, ``requires_grad`` kept,
    a leaf that appears twice one tensor."""
    seen: dict = {}

    def one(t):
        if id(t) not in seen:
            seen[id(t)] = torch.empty(t.shape, dtype=t.dtype, device=dev
                                      ).requires_grad_(t.requires_grad)
        return seen[id(t)]

    return tree_map(one, tree)


def _fake_input(spec, dev):
    """A fake tensor for an ``input_specs.Spec`` (inside FakeTensorMode)."""
    return torch.empty(spec.shape, dtype=spec.dtype, device=dev)


def _local_bytes(tree) -> int:
    out = 0
    for _, t in leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            out += t.numel() * t.element_size()
    return out


def _stats_fields(result: dict, stats: dict) -> None:
    result["cost_analysis"] = {"flops": stats["dot_flops"],
                               "bytes accessed": stats["mem_bytes"]}
    result["hlo_stats"] = stats
    result["collectives"] = {
        "total_bytes": stats["collective_total"],
        "per_op_bytes": stats["collective_bytes"],
        "counts": stats["collective_counts"],
    }
    if stats.get("cpu_alltoall_fallbacks"):
        result["collective_fallback"] = "cpu_all_gather"


def trace_step(model, shape, mesh, optimized: bool = False,
               anchors: bool | None = None, step_kw: dict | None = None) -> dict:
    """Trace one cell's step of ``model`` at ``shape`` (a ``ShapeConfig``)
    on ``mesh``, in the running world (fake tensors, ``OpCounter``): the
    per-device fields of the cell's JSON. ``optimized`` turns on the
    activation anchors (``anchors`` None follows it; ``launch.perf_cell``
    sets them alone), sequence parallelism for prefill and, for decode,
    the FSDP drop. ``step_kw`` goes to ``make_train_step``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import mesh_device
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = model.cfg
    dev = mesh_device(mesh)
    result: dict = {}
    pspecs = make_param_specs(model, mesh)
    pshapes = param_shapes(model)
    result["param_count"] = int(sum(t.numel() for _, t in leaves(pshapes)))
    result["param_bytes_per_device"] = _sharded_bytes(pshapes, pspecs, mesh)
    if anchors is None:
        anchors = optimized
    if anchors:
        # activation anchors everywhere; sequence parallelism for prefill
        hints.set_axes(batch_axes(mesh), mesh=mesh, seq_parallel=(
            optimized and shape.kind == "prefill"))
    else:
        # no anchors (repro's hints.clear()); plain tensors still count as
        # replicated on the mesh
        hints.set_axes(None, None, mesh=mesh)
    if shape.kind == "train":
        sspecs = make_state_specs(model, mesh)
        sshapes = init_state(model, None, device="meta")
        result["state_bytes_per_device"] = _state_bytes(model, sshapes,
                                                        sspecs, mesh)
        device_bytes = result["state_bytes_per_device"]
    else:
        cshapes = cache_shapes(model, shape)
        cspecs = make_cache_specs(model, mesh, shape.global_batch,
                                  shape.seq_len)
        result["cache_bytes_per_device"] = _sharded_bytes(cshapes, cspecs,
                                                          mesh)
        if shape.kind == "decode" and optimized:
            # inference has no optimizer state: when the TP-sharded weights
            # and the cache fit, drop FSDP and its per-layer all-gathers,
            # only where the batch shards the data axes
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            tp_resident = _bytes_of(pshapes) / sizes["model"]
            ways = 1
            for a in batch_axes(mesh):
                ways *= sizes[a]
            fits = (tp_resident + result["cache_bytes_per_device"]
                    <= DECODE_BUDGET)
            result["decode_fsdp"] = not (fits and shape.global_batch % ways == 0)
            if not result["decode_fsdp"]:
                pspecs = make_param_specs(model, mesh, fsdp_shard=False)
                result["param_bytes_per_device"] = _sharded_bytes(
                    pshapes, pspecs, mesh)
        device_bytes = (result["param_bytes_per_device"]
                        + result["cache_bytes_per_device"])
    result["device_bytes"] = device_bytes
    result["fits_one_card"] = device_bytes <= H100_HBM_BYTES

    t0 = time.time()
    try:
        with _real_shard_math(), FakeTensorMode():
            if shape.kind == "train":
                state = place(_fake_like(sshapes, dev), mesh, sspecs)
                # the step places the batch itself (make_batch_specs)
                batch = {k: _fake_input(v, dev) for k, v in
                         train_batch_specs(cfg, shape).items()}
                step = make_train_step(model, **(step_kw or {}))
                args = (state, place_batch(batch, mesh))  # their local bytes
                with OpCounter() as counter:
                    out = step(state, batch)
            else:
                params = place(_fake_like(pshapes, dev), mesh, pspecs)
                cache = place(_fake_like(cshapes, dev), mesh, cspecs)
                with torch.no_grad():
                    if shape.kind == "prefill":
                        inp = prefill_inputs(cfg, shape)
                        key = "embeds" if "embeds" in inp else "tokens"
                        x = place_batch({key: _fake_input(inp[key], dev)},
                                        mesh)[key]
                        args = (params, cache, x)
                        with OpCounter() as counter:
                            if model.prefill is not None:
                                out = model.prefill(params, cache, **{key: x})
                            else:  # hybrid: prefill compute == forward
                                out = model.forward(params, **{key: x})
                    else:
                        inp = decode_inputs(cfg, shape)
                        tok = place_batch(
                            {"tokens": _fake_input(inp["tokens"], dev)},
                            mesh)["tokens"]
                        args = (params, cache, tok)
                        pos = shape.seq_len - 1  # the cell's whole context
                        with OpCounter() as counter:
                            out = model.decode_step(params, cache, tok, pos)
    finally:
        hints.clear()
    result["trace_s"] = round(time.time() - t0, 2)
    result["memory_analysis"] = {"argument_size_in_bytes": _local_bytes(args),
                                 "output_size_in_bytes": _local_bytes(out)}
    _stats_fields(result, counter.stats())
    return result


def _config(arch: str, shape_name: str, optimized: bool,
            reduced: bool = False):
    cfg = ARCHS[arch].reduced() if reduced else ARCHS[arch]
    if optimized:
        over = OPT_OVERRIDES.get(arch, {}).get(shape_name)
        if over:
            cfg = dataclasses.replace(cfg, **over)
    return cfg


@contextlib.contextmanager
def world_mesh(multi_pod: bool, mesh_shape: tuple | None = None,
               device: str | None = None):
    """A fake world and its mesh: the production mesh, or with
    ``mesh_shape`` a small one (2 dimensions ``("data", "model")``, 3
    ``("pod", "data", "model")``), on ``device`` (by default the card
    where one is present)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    if mesh_shape is not None:
        shape = tuple(mesh_shape)
        names = ("pod", "data", "model")[-len(shape):]
    n = 1
    for d in shape:
        n *= d
    device = device or device_type()
    with fake_world(n):
        if mesh_shape is None:
            yield make_production_mesh(multi_pod=multi_pod, device_type=device)
        else:
            yield init_device_mesh(device, shape, mesh_dim_names=names)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               optimized: bool = False, mesh_shape: tuple | None = None,
               reduced: bool = False, device: str | None = None) -> dict:
    """One cell's JSON (``repro``'s keys). ``mesh_shape``, ``reduced`` and
    ``device`` are the port's own: a small mesh in place of the
    production one, the arch's ``reduced()`` config (tests and CPU runs),
    and the mesh's device where it is not the default (a CPU mesh on a
    card's host, whose all-to-alls DTensor runs as all-gathers)."""
    cfg = _config(arch, shape_name, optimized, reduced)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    t0 = time.time()
    with world_mesh(multi_pod, mesh_shape, device) as mesh:
        result: dict = {
            "arch": arch, "shape": shape_name,
            "multi_pod": "pod" in mesh.mesh_dim_names,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "kind": shape.kind, "device": mesh.device_type,
        }
        result.update(trace_step(build(cfg), shape, mesh, optimized))
    result["status"] = "ok"
    result["optimized"] = optimized
    if reduced:
        result["reduced"] = True
    result["total_s"] = round(time.time() - t0, 2)
    return result


def search_trace(mesh, sc, ref, query, device=None) -> dict:
    """The sharded search at ``sc`` (a ``DTWSearchConfig``) over every axis
    of ``mesh``, in the running world, for one query: this rank's result,
    rounds and per-round collectives."""
    from repro_torch.search.distributed import make_distributed_search

    from repro_torch.kernels import ops

    axes = tuple(mesh.mesh_dim_names)
    search = make_distributed_search(
        mesh, axes, length=sc.query_len, window=sc.window, batch=sc.batch,
        device=device)
    before = {k: getattr(ops, k).launches for k in KERNELS}
    t0 = time.time()
    with OpCounter() as counter:
        res = search(ref, query)
        rounds = int(res.rounds)
    elapsed = time.time() - t0
    launches = {k: getattr(ops, k).launches - n for k, n in before.items()}
    # the program's collectives, each over every axis's group in turn: the
    # quarantine count's sum, two all-reduces a round (the incumbent's MIN,
    # the continue flag's MAX), and three to reconcile
    g = len(axes)
    events = counter.events
    loop = events[g:len(events) - 3 * g]
    if len(loop) != 2 * g * rounds:
        raise RuntimeError(
            f"{len(events)} collectives for {rounds} rounds over {g} axes: "
            "the search's collectives are not the ones counted here")
    per_round: dict = {}
    for kind, moved in loop[:2 * g]:
        slot = per_round.setdefault(kind, {"count": 0, "bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += moved
    out = {"best_start": int(res.best_start), "best_dist": float(res.best_dist),
           "rounds": rounds, "per_round": per_round, "search_s": elapsed,
           "windows_per_rank": -(-(len(ref) - sc.query_len + 1) // mesh.size()),
           "kernel_launches": launches}
    _stats_fields(out, counter.stats())
    return out


def lower_search_cell(multi_pod: bool, sc=None, seed: int = 0) -> dict:
    """Dry-run the paper's own workload: distributed EAPrunedDTW search
    sharded over every axis of the production mesh, rank 0's range run
    for real on its device."""
    import numpy as np

    from repro_torch.configs import SEARCH_CONFIG
    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.launch.mesh import mesh_device

    sc = sc or SEARCH_CONFIG
    t0 = time.time()
    ref = make_dataset(SEARCH_DATASET, sc.ref_len, seed=seed).astype(np.float32)
    query = make_queries(SEARCH_DATASET, 1, sc.query_len,
                         seed=seed + 1)[0].astype(np.float32)
    with world_mesh(multi_pod) as mesh:
        result: dict = {
            "arch": "dtw-search", "shape": f"N{sc.ref_len}_l{sc.query_len}",
            "multi_pod": multi_pod, "kind": "search", "device": mesh.device_type,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        }
        result.update(search_trace(mesh, sc, ref, query, mesh_device(mesh)))
    result["note"] = (
        "search rounds are data-dependent; the collective counts and bytes "
        "are per round (per_round) and for rank 0's whole run, whose rounds "
        "are its own range's (a fake group shares no incumbent)")
    result["status"] = "ok"
    result["total_s"] = round(time.time() - t0, 2)
    return result


def cell_path(arch, shape_name, multi_pod, optimized=False, mesh_shape=None,
              reduced=False, device=None):
    """``repro``'s file name; the port's own options add to it."""
    tag = "multipod" if multi_pod else "pod"
    base = OPT_RESULTS_DIR if optimized else RESULTS_DIR
    extra = "".join((
        "__mesh-" + "x".join(map(str, mesh_shape)) if mesh_shape else "",
        "__reduced" if reduced else "",
        f"__{device}-mesh" if device else ""))
    return os.path.join(base, f"{arch}__{shape_name}__{tag}{extra}.json")


def _error(res: dict) -> dict:
    exc = sys.exc_info()[1]
    return {**res, "status": "error", "error": f"{type(exc).__name__}: {exc}",
            "traceback": traceback.format_exc()[-4000:]}


def run_cell(arch, shape_name, multi_pod, force=False, optimized=False,
             mesh_shape=None, reduced=False, device=None) -> dict:
    path = cell_path(arch, shape_name, multi_pod, optimized, mesh_shape,
                     reduced, device)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        res = lower_cell(arch, shape_name, multi_pod, optimized,
                         mesh_shape, reduced, device)
    except Exception:
        res = _error({"arch": arch, "shape": shape_name,
                      "multi_pod": multi_pod})
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--search", action="store_true",
                    help="dry-run the paper's search workload")
    ap.add_argument("--opt", action="store_true",
                    help="optimized shardings (results/dryrun_torch_opt)")
    ap.add_argument("--mesh", default=None,
                    help="a small mesh in place of the production one, as "
                    "2x2 (data x model) or 2x1x2 (pod x data x model); the "
                    "port's own")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced() config (the port's own)")
    ap.add_argument("--mesh-device", default=None, choices=("cuda", "cpu"),
                    help="the mesh's device (default: the card where one "
                    "is present; the port's own)")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.both_meshes:
        # one process a mesh size: a fake world of each size of its own
        argv = [a for a in (sys.argv[1:] if argv is None else argv)
                if a not in ("--both-meshes", "--multipod")]
        rcs = [subprocess.call([sys.executable, "-m", "repro_torch.launch.dryrun"]
                               + argv + extra) for extra in ([], ["--multipod"])]
        if any(rcs):
            raise SystemExit(1)
        return

    if args.search:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        tag = "multipod" if args.multipod else "pod"
        path = os.path.join(RESULTS_DIR, f"dtw-search__{tag}.json")
        if os.path.exists(path) and not args.force:
            return
        try:
            res = lower_search_cell(args.multipod)
        except Exception:
            res = _error({"arch": "dtw-search", "multi_pod": args.multipod})
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"{res.get('status', '?').upper():5s} dtw-search {tag} "
              f"rounds={res.get('rounds')} "
              f"coll={res.get('collectives', {}).get('total_bytes', 0):.3e}B "
              f"trace={res.get('total_s', 0)}s", flush=True)
        if res["status"] != "ok":
            print(res.get("error"), flush=True)
            raise SystemExit(1)
        return

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    mesh_shape = tuple(int(n) for n in args.mesh.split("x")) if args.mesh else None
    mp = args.multipod or (mesh_shape is not None and len(mesh_shape) == 3)
    tag = args.mesh or ("multipod" if mp else "pod")
    n_ok = n_skip = n_err = 0
    for a in archs:
        for s in shapes:
            res = run_cell(a, s, mp, force=args.force, optimized=args.opt,
                           mesh_shape=mesh_shape, reduced=args.reduced,
                           device=args.mesh_device)
            status = res.get("status")
            if status == "ok":
                n_ok += 1
                ca = res.get("cost_analysis", {})
                print(
                    f"OK   {a:24s} {s:12s} {tag:8s} "
                    f"flops={ca.get('flops', 0):.3e} "
                    f"bytes={ca.get('bytes accessed', 0):.3e} "
                    f"coll={res['collectives'].get('total_bytes', 0):.3e}B "
                    f"{json.dumps(res['collectives'].get('counts', {}))} "
                    f"trace={res.get('trace_s', 0):.1f}s",
                    flush=True,
                )
            elif status == "skipped":
                n_skip += 1
                print(f"SKIP {a:24s} {s:12s} {tag:8s} ({res['reason']})",
                      flush=True)
            else:
                n_err += 1
                print(f"ERR  {a:24s} {s:12s} {tag:8s} {res.get('error')}",
                      flush=True)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
