"""Device: the share of the traced window in which the card was idle while
a span "serving.host_half" (the native component filter and the
labelmap of the last case) was open, in % (portbench/spans.py; a stock
run keeps no spans and reads nothing)."""


def read(run):
    program = getattr(run.trace, "program", None)
    if program is None or run.trace.window_s <= 0:
        return None
    return 100.0 * program.idle_s("serving.host_half") / run.trace.window_s
