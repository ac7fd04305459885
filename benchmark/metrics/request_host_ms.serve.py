"""Host milliseconds a request spends in ``Predictor.rollout`` (placing the
numpy inputs, dispatching the generator calls) until it returns, the mean
over the window's requests (the benchmark's own spans)."""


def read(run):
    calls = run.spans.get("rollout")
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
