"""PyTorch/CUDA port of the EAPrunedDTW similarity-search system.

A second package beside ``repro`` (the JAX reference, which stays as it
is). It imports ``torch`` and ``numpy`` only and mirrors ``repro``'s
layout (``core/``, ``search/``, ``kernels/``, ``configs/``, ``data/``,
``launch/``), so each module's counterpart is found at the same path.

This slice covers the main path: offline subsequence search with
EAPrunedDTW under the default plan (``variant="eapruned"`` or
``"eapruned_nolb"``, ``rounds="host"``, ``gather="fused"``), reached through
``search.multi.multi_query_search`` and
``search.subsequence.subsequence_search``. Its two kernels are CUDA C++ for
``sm_90a`` (``kernels/csrc``); on CPU tensors each kernel's wrapper runs
the kernel's plain PyTorch version instead.

Entry points take a ``device`` argument and run on CUDA unless the caller
passes ``device="cpu"``; with no device given and no CUDA present they
raise rather than carry on on the CPU.
"""
