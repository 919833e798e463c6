"""PyTorch/CUDA port of the EAPrunedDTW similarity-search system.

A second package beside ``repro`` (the JAX reference, which stays as it
is). It imports ``torch`` and ``numpy`` only and mirrors ``repro``'s
layout (``core/``, ``search/``, ``serve/``, ``kernels/``, ``configs/``,
``data/``, ``launch/``, ``models/``), so each module's counterpart is found at the same path.

It covers offline subsequence search (``search.multi.multi_query_search``,
``search.subsequence.subsequence_search``) under both round drivers
(``rounds="host"`` or ``"persistent"``) and both gather modes, with the
paper's counters and its four suites (``eapruned``, ``eapruned_nolb``,
``full``, ``pruned``); streaming search (``serve.StreamSearchEngine``,
``search.streaming``); the core API (``core``); and the fault-tolerant
host layer: the executor seam (``search.pipeline``: host-rounds,
persistent and hedged executors), ``search.resilient.resilient_search``,
``serve.SearchSupervisor``, ``train.checkpoint`` and
``distributed.fault_tolerance``. The five kernels
(A-E, one for each ``pl.pallas_call`` of ``repro``) are CUDA C++ for
``sm_90a`` (``kernels/csrc``); on CPU tensors each kernel's wrapper runs the
kernel's plain PyTorch version instead. Sharded search runs on
``torch.distributed`` (``search.pipeline.make_sharded_search``,
``search.distributed``).

LM serving is ported too: the four model families' forward passes,
caches, prefill and decode (``models``), the registry
(``models.registry.build``), ``serve.generate`` and ``launch.serve``, with
the ten architecture configs (``configs.ARCHS``). It reaches no Pallas
kernel in ``repro`` and runs on PyTorch ops. So does LM training: the
optimizers, gradient compression and the microbatched train step
(``train``), the token stream (``data.lm``), ``TrainingSupervisor``
(``distributed.fault_tolerance``) and ``launch.train``. The train state
is placed by ``repro``'s partitioning rules over a ``torch.distributed``
``DeviceMesh`` as DTensors (``distributed.sharding``, ``launch.mesh``),
with real activation anchors (``distributed.hints``), the expert-parallel
MoE (``models.mlp.moe_ep``) and ``elastic_reshard``; serving runs on
placed parameters and caches too. The dry-run (``launch.dryrun``: every
cell of ``repro``'s traced on torch's ``fake`` process group under
``FakeTensorMode``), ``launch.perf_cell`` and the roofline
(``roofline.op_stats``, ``roofline.analysis``, on the H100's rates)
complete it: the port does all that ``repro`` does, but for three
modules it needs no counterpart of (``core/backend.py``,
``core/compat.py``, ``kernels/ref.py``).

Entry points take a ``device`` argument and run on CUDA unless the caller
passes ``device="cpu"``; with no device given and no CUDA present they
raise rather than carry on on the CPU.
"""
