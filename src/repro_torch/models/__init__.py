"""Language-model families of the port (port of ``repro/models``).

Forward passes, caches, prefill and decode of the four families
(``transformer``, ``mamba2``, ``rglru``, ``whisper``) and the uniform API
over them (``registry.build``). Parameters are a ``common.ParamTree``: a
module whose nested entries keep ``repro``'s names, with per-layer lists
where ``repro`` stacks layers on a leading axis. No Pallas kernel of
``repro`` lies on these paths, so the port runs them as PyTorch ops.
"""
