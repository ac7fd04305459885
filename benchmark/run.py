"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload config5.train --seed 7 --seconds 20 --trace 0

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s`` of the traced stretch), with ``--trace 1``
``breakdown``, and last ``check``: each number the output check compared,
with its limit. The same numbers are the last lines on standard error.
The run exits non-zero and prints no result without as many CUDA cards as
the cell asks for, or when a module of JAX or of the JAX package was
loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root, not this directory: the benchmark is the package
# ``benchmark`` beside the program's package.
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    chips = harness.find_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {chips} CUDA card(s); this machine has {found}",
              file=sys.stderr)
        return 2
    card = harness.card_line()
    if card:
        print(f"bench: card {card}", file=sys.stderr)
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), STARTED)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}, which it must not", file=sys.stderr)
        return 3
    harness.print_check(line)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
