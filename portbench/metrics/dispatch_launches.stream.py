"""Serving, main thread: the device operations (kernels, copies, sets)
launched a case inside the span "serving.dispatch", the enqueue of a
case's device half, in the traced window (portbench/spans.py lays the
program's spans over the device trace; a stock run keeps no spans and
reads nothing)."""


def read(run):
    program = getattr(run.trace, "program", None)
    if program is None or not run.trace_cases:
        return None
    return program.launches("serving.dispatch") / run.trace_cases
