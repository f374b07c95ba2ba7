"""Device: milliseconds a case in which an operation ran on the card (the
union of the traced window's device operations over its cases)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.trace_cases:
        return None
    return 1e3 * t.busy_s / run.trace_cases
