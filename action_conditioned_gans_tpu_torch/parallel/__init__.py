"""Data parallelism over a ``torch.distributed`` process group (port of the
JAX package's ``parallel/``): the mesh record and the batch layout
(``parallel.mesh``), the collectives of the step (``parallel.comm``) and the
data-parallel step (``parallel.dp``). Channel tensor parallelism (the JAX
``parallel/gspmd.py``) is ROADMAP Queue 1 item 8. The package imports
nothing, so that ``train.step`` can import ``parallel.comm``."""
