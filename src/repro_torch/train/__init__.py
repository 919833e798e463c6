"""Training-side utilities (port of ``repro.train``): the checkpoint store
that ``serve.supervisor.SearchSupervisor`` writes. The LM trainer is not
ported yet (ROADMAP.md Queue 1 item 7b).
"""
