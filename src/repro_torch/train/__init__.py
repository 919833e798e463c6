"""Training (port of ``repro.train``): the optimizers (AdamW, Adafactor),
int8 gradient compression with error feedback, the microbatched train
step, ``repro``'s stacked-leaf layout over the port's per-layer lists
(``layout``), and the checkpoint store that ``TrainingSupervisor`` and
``serve.supervisor.SearchSupervisor`` write.
"""
