"""The paper's own workload: UCR-suite subsequence similarity search.

Port of ``repro/configs/dtw_search.py`` with only the knobs this slice
reads. The sizes follow the paper's §5 protocol (Herrmann & Webb 2020): a
reference of N = 1,000,000 samples, queries of l = 1024, window ratio 0.1
(w = 102), Q = 8 standing queries and 256 candidates per query per round.
See ``repro``'s config for what each knob does; ``backend`` has no
counterpart (the port dispatches by device). The Pallas tiling knobs
``rows_per_step`` and ``row_block`` change nothing here, so ``make_plan``'s
defaults supply them; ``block_k`` sets the granularity of the persistent
sweep's ``blocks`` work metric. The streaming, resilience and hedging knobs
belong to modules not ported yet.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class SearchConfig:
    name: str = "dtw-search"
    ref_len: int = 1_000_000         # long reference series R
    query_len: int = 1024            # paper: 128 / 256 / 512 / 1024
    window_ratio: float = 0.1        # paper: 0.1 .. 0.5
    batch: int = 256                 # candidates per query per round
    variant: str = "eapruned"
    band_width: int | None = None    # None = warp-aligned 2*window+1
    block_k: int = 8                 # persistent sweep: lanes per work block
    rounds: str = "host"             # round driver: "host" | "persistent"
    gather: str = "fused"            # candidate materialization (§2.10)
    slab_budget: int | None = None   # byte cap on host-side slabs (§2.10)
    n_queries: int = 8               # multi-query workload size
    warm_start: int = 0              # incumbent-seeding prepass
    quarantine: bool = True          # non-finite window quarantine (§2.6)

    @property
    def window(self) -> int:
        return int(self.query_len * self.window_ratio)

    def make_plan(self, **overrides):
        """Resolve this config into the pipeline's ``SearchPlan``;
        ``overrides`` replace individual knobs."""
        from repro_torch.search.pipeline import make_plan

        kw = dict(
            length=self.query_len,
            window=self.window,
            variant=self.variant,
            batch=self.batch,
            band_width=self.band_width,
            block_k=self.block_k,
            rounds=self.rounds,
            gather=self.gather,
            slab_budget=self.slab_budget,
            quarantine=self.quarantine,
            warm_start=self.warm_start,
        )
        kw.update(overrides)
        return make_plan(**kw)


CONFIG = SearchConfig()
