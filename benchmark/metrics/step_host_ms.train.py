"""Host milliseconds a step spends in the program's call, from entering the
call to its return, over the window's calls (the benchmark's own spans)."""


def read(run):
    calls = run.spans.get("call")
    if not calls or not run.units:
        return None
    return 1e3 * sum(calls) / run.units
