"""Device: the share of the traced window in which the card was idle while
the main thread was in the span "serving.upload" (the copies of a case's
CT and mask to the card), in % (portbench/spans.py; a stock run keeps no
spans and reads nothing)."""


def read(run):
    program = getattr(run.trace, "program", None)
    if program is None or run.trace.window_s <= 0:
        return None
    return 100.0 * program.idle_s("serving.upload") / run.trace.window_s
