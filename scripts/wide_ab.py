#!/usr/bin/env python3
"""The wide DTW row's kernels of two checkouts on one card: bits and times.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/wide_ab.py build/parent .

A process of this checkout first makes the inputs: at each band of
``chip_smoke.WIDE_BANDS`` (l = 2048 / 8192 / 16,384, bw = 2048 / 1664 /
16,384) the first K best-first lanes of Q queries over the ECG reference
of ``WIDE_REF_N`` samples (``chip_smoke.wide_lanes``), a bound a lane
(each query's median of kernel A's free distances), the window slab and
the host cb slab; and queries of ``WIDE_FULL_N`` samples for kernel D's
full rows (n != m, bw = m). Then each checkout runs the same inputs in
processes of its own (its own ``repro_torch`` and its own build of the
kernels), in the order a, b, b, a (with more checkouts: each in turn, then
in reverse): kernels A and D one round (``use_cb`` on and off, with and
without counters), C and E the cold sweep of all the band's lanes
(``use_cb`` on and off), D on full rows (with and without counters). Each
call is timed by CUDA events (one warm-up call, whose outputs are kept,
then the mean of a few). The script prints whether every output has the
same bits as in the first checkout, each kernel's milliseconds in every
checkout (the mean of its two processes), and each wide kernel's
registers (ptxas) and count of instructions, and of shared, global and
generic memory instructions, barriers, shuffles and shared atomics, in its
SASS
(``cuobjdump -sass``). It exits 1 if any bit differs. Needs the card and
``nvcc``; about 2 minutes on one H100 for two checkouts.
"""
from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUOBJDUMP = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                         "cuobjdump")
LIBS = ("dtw_ea_fused", "dtw_ea_slab", "dtw_ea_persistent")
# SASS opcodes counted in each wide kernel, by the start of their name
# (beside its count of instructions).
OPS = ("LDS", "STS", "LDG", "STG", "LD.", "ST.", "BAR", "ATOMS", "SHFL",
       "REDUX")


def make_inputs(out: str) -> None:
    """The lanes, bounds and slabs of every band, saved to ``out``."""
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import torch

    import chip_smoke as cs
    from repro_torch.core.common import BIG
    from repro_torch.core.lower_bounds import cascade_keogh_cumulative
    from repro_torch.data.synthetic import make_dataset, make_queries
    from repro_torch.kernels import ops
    from repro_torch.kernels.dtw_band import gather_norm_lanes
    from repro_torch.kernels import _build
    from repro_torch.search.znorm import znorm

    # a build of its own, so that this checkout's --dump process builds
    # (and reports ptxas's registers) as every other checkout's does
    _build.BUILD_DIR = _build.Path(out).parent / "inputs_build"
    ref = torch.as_tensor(make_dataset(cs.DATASET, cs.WIDE_REF_N, seed=0),
                          dtype=torch.float32, device="cuda")
    bands = []
    for length, ratio, nq, k, _ in cs.WIDE_BANDS:
        plan, pq, lanes = cs.wide_lanes(torch, ref, length, ratio, nq, k)
        qn, sref, lb, s32, mu, sg = lanes
        w, m = plan.window, plan.length
        slab = gather_norm_lanes(sref, s32, mu, sg, m)[0].contiguous()
        u, low = pq.u.contiguous(), pq.low.contiguous()
        cbs = cascade_keogh_cumulative(slab, u[:, None, :],
                                       low[:, None, :]).contiguous()
        big = torch.full((nq, k), BIG, dtype=torch.float32, device="cuda")
        ub = {cb: cs.median_ub(torch, ops.dtw_ea_multi_fused(
            qn, sref, s32, mu, sg, big, w, m, u=u, low=low, use_cb=cb))
            for cb in (True, False)}
        bands.append(dict(m=m, w=w, block_k=plan.block_k, lanes=lanes,
                          u=u, low=low, slab=slab, cbs=cbs, ub=ub))
    b0 = bands[0]
    qf = znorm(torch.as_tensor(
        make_queries(cs.DATASET, b0["lanes"][0].shape[0], cs.WIDE_FULL_N,
                     seed=5), dtype=torch.float32, device="cuda"))
    big = torch.full(b0["slab"].shape[:2], BIG, dtype=torch.float32,
                     device="cuda")
    full = dict(qf=qf, ub=cs.median_ub(torch, ops.dtw_ea_multi(
        qf, b0["slab"], big, b0["w"])))
    torch.cuda.synchronize()
    torch.save({"bands": bands, "full": full}, out)


def dump(tree: str, inputs: str, out: str) -> None:
    """Run checkout ``tree``'s wide kernels on the inputs; save outputs,
    times, ptxas's registers and the library paths to ``out``."""
    sys.path[:0] = [os.path.join(tree, "src")]
    import torch

    from repro_torch.core.common import BIG
    from repro_torch.kernels import _build, ops

    _build.build()
    data = torch.load(inputs)
    res, ms = {}, {}

    def run(key, fn, reps):
        got = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        ms[key] = start.elapsed_time(stop) / reps
        res[key] = got

    for b in data["bands"]:
        qn, sref, lb, s32, mu, sg = b["lanes"]
        m, w, slab = b["m"], b["w"], b["slab"]
        reps = 5 if m <= 2048 else 3 if m <= 8192 else 2
        cold = torch.full((qn.shape[0],), BIG, dtype=torch.float32,
                          device="cuda")
        for cb in (True, False):
            env = dict(u=b["u"], low=b["low"], use_cb=cb)
            ub = b["ub"][cb]
            cbs = b["cbs"] if cb else None
            for info in (False, True):
                tag = f"l={m} use_cb={cb}" + (" info" if info else "")
                run(f"A {tag}", lambda: ops.dtw_ea_multi_fused(
                    qn, sref, s32, mu, sg, ub, w, m, with_info=info, **env),
                    reps)
                run(f"D {tag}", lambda: ops.dtw_ea_multi(
                    qn, slab, ub, w, cb=cbs, with_info=info), reps)
            tag = f"l={m} use_cb={cb}"
            run(f"C {tag}", lambda: ops.dtw_ea_persistent_fused(
                *b["lanes"], cold, w, m, block_k=b["block_k"], **env)[:2],
                reps)
            run(f"E {tag}", lambda: ops.dtw_ea_persistent(
                qn, slab, lb, s32, cold, w, block_k=b["block_k"], **env)[:2],
                reps)
    b0, full = data["bands"][0], data["full"]
    for info in (False, True):
        run("D full rows" + (" info" if info else ""),
            lambda: ops.dtw_ea_multi(full["qf"], b0["slab"], full["ub"],
                                     b0["w"], with_info=info), 5)
    regs = {}
    for name in LIBS:
        inst = None
        for ln in _build.build_log.get(name, (0, ""))[1].splitlines():
            hit = re.search(r"Compiling entry function '(\S+)'", ln)
            if hit:
                inst = hit.group(1) if "wide" in hit.group(1) else None
            elif inst and ("registers" in ln or "spill" in ln):
                regs.setdefault(inst, []).append(" ".join(ln.split()))
    flat = {k: [t.cpu() for t in (v if isinstance(v, tuple) else (v,))]
            for k, v in res.items()}
    torch.save({"outputs": flat, "ms": ms, "regs": regs,
                "libs": {n: str(_build.library_path(n)) for n in LIBS}}, out)


def short(name: str) -> str:
    """A wide kernel's mangled name as ``kernel<bools>``."""
    base = re.search(r"dtw_ea_fused_wide_kernel|dtw_ea_slab_wide_kernel|"
                     r"persistent_sweep_wide", name)
    flags = re.findall(r"Lb([01])E", name)
    return f"{base.group(0) if base else name}<{','.join(flags)}>"


def sass_counts(lib: str) -> dict[str, collections.Counter]:
    """Each wide kernel's count of the ``OPS`` opcodes in ``lib``."""
    text = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        hit = re.search(r"Function : (\S+)", ln)
        if hit:
            cur = short(hit.group(1)) if "wide" in hit.group(1) else None
            if cur:
                out[cur] = collections.Counter()
            continue
        ins = re.search(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)", ln)
        if cur and ins:
            op = ins.group(1)
            out[cur]["instructions"] += 1
            for kind in OPS:
                if op.startswith(kind):
                    out[cur][op] += 1
    return out


def main() -> int:
    if sys.argv[1:2] == ["--inputs"]:
        make_inputs(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--dump"]:
        dump(sys.argv[2], sys.argv[3], sys.argv[4])
        return 0
    import torch

    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    tmp = tempfile.mkdtemp(prefix="wide_ab_")
    me = os.path.abspath(__file__)
    inputs = os.path.join(tmp, "inputs.pt")
    subprocess.run([sys.executable, me, "--inputs", inputs], check=True)
    runs = collections.defaultdict(list)
    for i, tree in enumerate(trees + trees[::-1]):
        path = os.path.join(tmp, f"{i}.pt")
        subprocess.run([sys.executable, me, "--dump", tree, inputs, path],
                       check=True)
        runs[tree].append(torch.load(path))
    first = runs[trees[0]][0]
    ok = True
    for tree in trees[1:]:
        got = runs[tree][0]["outputs"]
        same = {}
        for key, want in first["outputs"].items():
            same[key] = all(
                torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                            y.view(torch.int32) if y.is_floating_point() else y)
                for x, y in zip(want, got[key]))
        ok &= all(same.values())
        print(f"outputs with the same bits in {sys.argv[1]} and "
              f"{sys.argv[1 + trees.index(tree)]}: {sum(same.values())} of "
              f"{len(same)}"
              + "".join(f"; {k} differs" for k, v in same.items() if not v))
    names = [sys.argv[1 + i] for i in range(len(trees))]
    print("ms (CUDA events, the mean of each checkout's two processes; "
          "each process's own in brackets): " + " | ".join(names))
    for key in first["ms"]:
        cols = []
        for tree in trees:
            each = [r["ms"][key] for r in runs[tree]]
            cols.append(f"{sum(each) / len(each):.3f} "
                        f"[{', '.join(f'{v:.3f}' for v in each)}]")
        ratio = (sum(r["ms"][key] for r in runs[trees[-1]])
                 / sum(r["ms"][key] for r in runs[trees[0]]))
        print(f"  {key}: {' | '.join(cols)}; last/first {ratio:.3f}")
    for tree, name in zip(trees, names):
        r = runs[tree][0]
        print(f"{name}: wide kernels' registers (ptxas)")
        for inst, lines in sorted(r["regs"].items()):
            print(f"  {short(inst)}: {' | '.join(lines)}")
        for lib in LIBS:
            for kern, cnt in sorted(sass_counts(r["libs"][lib]).items()):
                print(f"  SASS {kern}: " + ", ".join(
                    f"{op} {n}" for op, n in sorted(cnt.items())))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
