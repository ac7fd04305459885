"""The program's own spans and counters, for the per-layer readers that
read them: ``action_conditioned_gans_tpu_torch.utils.profiling``'s ring of
records, in the process that ran the cell.

The recorder is always on, so after a run the ring holds every unit the
run made: the set-up's warm units, the untraced window's (most of them)
and the traced stretch's, whose host times the profiler lengthens. A
reader cannot tell where the window began, so it takes the median over
units. A unit is one request (its ``rollout`` span and the spans inside
it), one training step (``step`` and its phases) or one training call
(``train_call[k=K]``). Each reader returns None without a trace, or where
the program keeps no such recorder (a checkout from before it), and 0.0
where the recorder holds no unit of the kind.
"""

from __future__ import annotations

import collections
import statistics
from typing import Callable, List, Optional


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from action_conditioned_gans_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") else None


def median_per_unit(run, is_root: Callable, value: Callable) -> Optional[float]:
    """The median over the records for which ``is_root`` holds of
    ``value(root, records of its unit)``; see the module's docstring."""
    prof = recorder() if run.trace is not None else None
    if prof is None:
        return None
    records = prof.records()
    units = collections.defaultdict(list)
    for r in records:
        units[r.unit].append(r)
    values = [value(r, units[r.unit]) for r in records if is_root(r)]
    return float(statistics.median(values)) if values else 0.0


def named(name: str) -> Callable:
    return lambda r: r.name == name


def timed(name: str) -> Callable:
    """The records named ``name`` whose device time the program took (on
    CUDA it times a step only every so often: ``DEVICE_EVERY_NS``)."""
    return lambda r: r.name == name and r.device_ms is not None


def host_ms(records: List, name: str) -> float:
    return sum(r.host_ms for r in records if r.name == name)


def device_ms(records: List, *names: str) -> float:
    return sum(r.device_ms or 0.0 for r in records if r.name in names)
