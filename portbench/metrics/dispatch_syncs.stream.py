"""Serving, main thread: the runtime calls a case inside the span
"serving.dispatch" that hold the host until the card reaches them
(portbench/spans.py: SYNC_CALLS, the device, stream and event syncs, the
blocking copies and frees; and copies whose device operation is from or
to pageable memory), in the traced window (a stock run keeps no spans and
reads nothing)."""


def read(run):
    program = getattr(run.trace, "program", None)
    if program is None or not run.trace_cases:
        return None
    return program.syncs("serving.dispatch") / run.trace_cases
