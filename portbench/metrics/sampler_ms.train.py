"""Data store (data/store.py:sample_batch via trainer.batch_fn): the mean
device milliseconds between CUDA events recorded around each step's
sampler call in the benchmark's loop."""


def read(run):
    spans = run.spans.get("sampler_ms")
    return sum(spans) / len(spans) if spans else None
