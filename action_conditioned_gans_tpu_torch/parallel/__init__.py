"""Data and channel tensor parallelism over a ``torch.distributed`` process
group (port of the JAX package's ``parallel/``): the mesh record and the
batch layout (``parallel.mesh``), the collectives of the step
(``parallel.comm``), the data-parallel step (``parallel.dp``) and the
channel sharding of the state and the dp x tp step (``parallel.tp``, the
JAX ``parallel/gspmd.py``). The package imports nothing, so that
``train.step`` can import ``parallel.comm``."""
