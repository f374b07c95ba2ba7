"""Train step (train/trainer.py): the device ms a step of the operations
launched inside the span "train.optimizer" (Adam's step) in the traced
window (portbench/spans.py; a stock run keeps no spans and reads
nothing)."""


def read(run):
    program = getattr(run.trace, "program", None)
    if program is None or not run.trace_steps:
        return None
    return 1e3 * program.device_s("train.optimizer") / run.trace_steps
