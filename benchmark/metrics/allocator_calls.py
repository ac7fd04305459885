"""The caching allocator's device allocations, frees and retries a training
step (``cudaMalloc`` and ``cudaFree`` calls, and frees-and-retries after a
failed allocation): the program's ``train_call[k=K]`` span's
``device_alloc`` + ``device_free`` + ``alloc_retries`` over its K steps,
the median over calls (``benchmark/program_spans.py``)."""

from benchmark import program_spans as ps

KEYS = ("device_alloc", "device_free", "alloc_retries")


def read(run):
    return ps.median_per_unit(
        run, lambda r: r.name.startswith("train_call["),
        lambda root, unit: sum(root.attrs.get(k, 0) for k in KEYS) / max(root.attrs.get("k", 1), 1))
