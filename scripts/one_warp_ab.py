#!/usr/bin/env python3
"""The one-warp DTW kernels of two checkouts on one card: output bits and SASS.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/one_warp_ab.py build/parent .

Each checkout runs in a process of its own (its own ``repro_torch`` and its
own build of the kernels): kernels A (``use_cb`` on and off, with and
without counters) and D (the host cb slab, with and without counters) over
the first 3 host rounds of the main path (N = 1e6 ECG, 8 queries of
l = 1024, w = 102: bw = 224, CPT = 8, as ``chip_smoke.py`` phase 3 builds
them), and kernels C and E over each query's first 4,096 best-first lanes.
The script prints whether every output has the same bits in both
checkouts, and whether each one-warp kernel's SASS (``cuobjdump -sass``,
addresses and column padding dropped, the anonymous namespace's name
normalized) is the same instruction for instruction. It exits 1 if either
differs. Needs the card and ``nvcc``.
"""
from __future__ import annotations

import glob
import os
import re
import subprocess
import sys
import tempfile

CUOBJDUMP = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                         "cuobjdump")
LIBS = ("dtw_ea_fused", "dtw_ea_slab", "dtw_ea_persistent")
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def dump(tree: str, out: str) -> None:
    """Run the kernels of checkout ``tree`` and save their outputs."""
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch

    import chip_smoke as cs
    from repro_torch.configs.dtw_search import SearchConfig
    from repro_torch.core.common import BIG, clamp_sigma
    from repro_torch.core.lower_bounds import cascade_keogh_cumulative
    from repro_torch.kernels import _build, ops
    from repro_torch.search.incumbents import fold_min, initial_state
    from repro_torch.search.pipeline import (
        cascade,
        prepare_queries,
        prepare_ref,
    )
    from repro_torch.search.znorm import gather_norm_windows

    _build.build()
    cfg = SearchConfig()
    ref, queries = cs.main_path_inputs(torch, cfg, "cuda")
    plan = cfg.make_plan()
    prep = prepare_ref(plan, ref)
    pq = prepare_queries(plan, queries)
    order, lb = cascade(plan, prep, pq.qn)
    qn, w, m = pq.qn.contiguous(), plan.window, plan.length
    env = dict(u=pq.u.contiguous(), low=pq.low.contiguous())
    state = initial_state(qn.shape[0], device="cuda")
    res = {}
    for r in range(3):
        starts, ub, lbs = cs.round_inputs(torch, plan, state, order, lb, r)
        s32 = starts.to(torch.int32).contiguous()
        mu = prep.mu[starts].contiguous()
        sg = clamp_sigma(prep.sigma)[starts].contiguous()
        ub = ub.contiguous()
        args = (qn, prep.ref, s32, mu, sg, ub, w, m)
        for cb in (True, False):
            res[f"A{r}{cb}"] = ops.dtw_ea_multi_fused(*args, use_cb=cb, **env)
            res[f"A{r}{cb}info"] = ops.dtw_ea_multi_fused(
                *args, use_cb=cb, with_info=True, **env)
        slab = gather_norm_windows(prep.ref, s32, m, prep.mu,
                                   prep.sigma).contiguous()
        cbs = cascade_keogh_cumulative(slab, pq.u[:, None, :],
                                       pq.low[:, None, :]).contiguous()
        res[f"D{r}"] = ops.dtw_ea_multi(qn, slab, ub, w, cb=cbs)
        res[f"D{r}info"] = ops.dtw_ea_multi(qn, slab, ub, w, cb=cbs,
                                            with_info=True)
        fold = torch.where(torch.isfinite(lbs), res[f"A{r}True"],
                           float("inf"))
        state, _ = fold_min(state, starts, fold)
    k = 4096
    st = order[:, :k]
    lanes = (qn, prep.ref, lb[:, :k].contiguous(),
             st.to(torch.int32).contiguous(), prep.mu[st].contiguous(),
             clamp_sigma(prep.sigma[st]).contiguous())
    cold = torch.full((qn.shape[0],), BIG, device="cuda")
    res["C"] = ops.dtw_ea_persistent_fused(*lanes, cold, w, m, use_cb=True,
                                           **env)[:2]
    slab = gather_norm_windows(prep.ref, st, m, prep.mu,
                               prep.sigma).contiguous()
    res["E"] = ops.dtw_ea_persistent(qn, slab, lanes[2], lanes[3], cold, w,
                                     use_cb=True, **env)[:2]
    torch.cuda.synchronize()
    flat = {key: [t.cpu() for t in (v if isinstance(v, tuple) else (v,))]
            for key, v in res.items()}
    torch.save({"outputs": flat,
                "libs": {n: str(_build.library_path(n)) for n in LIBS}}, out)


def sass(lib: str) -> dict[str, list[str]]:
    """Each kernel's SASS instructions in ``lib``, by normalized name."""
    text = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = ANON.sub("ANON", m.group(1))
            funcs[cur] = []
        elif cur is not None:
            ln = ANON.sub("ANON", re.sub(r"/\*[0-9a-f]{4}\*/", "", ln))
            funcs[cur].append(" ".join(ln.split()))
    return funcs


def main() -> int:
    if sys.argv[1:2] == ["--dump"]:
        dump(sys.argv[2], sys.argv[3])
        return 0
    import torch

    a_tree, b_tree = sys.argv[1:3]
    tmp = tempfile.mkdtemp(prefix="one_warp_ab_")
    out = {}
    for tree in (a_tree, b_tree):
        path = os.path.join(tmp, f"{len(out)}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--dump",
                        os.path.abspath(tree), path], check=True)
        out[tree] = torch.load(path)
    a, b = (out[t] for t in (a_tree, b_tree))
    same_bits = {key: all(torch.equal(x, y) for x, y in zip(v, b["outputs"][key]))
                 for key, v in a["outputs"].items()}
    print(f"outputs with the same bits in {a_tree} and {b_tree}: "
          f"{sum(same_bits.values())} of {len(same_bits)}"
          + "".join(f"; {k} differs" for k, v in same_bits.items() if not v))
    same_sass = True
    for name in LIBS:
        fa, fb = sass(a["libs"][name]), sass(b["libs"][name])
        one_warp = sorted(f for f in fa if "wide" not in f)
        diff = [f for f in one_warp if fa[f] != fb.get(f)]
        same_sass &= not diff
        print(f"{name}: {len(one_warp)} one-warp kernels, the same SASS: "
              f"{len(one_warp) - len(diff)}; differing: {diff}; only in "
              f"{b_tree}: {sorted(f for f in fb if f not in fa)}")
    return 0 if all(same_bits.values()) and same_sass else 1


if __name__ == "__main__":
    sys.exit(main())
