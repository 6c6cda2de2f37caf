"""Host milliseconds per pass inside the port's ``eval.upload`` span: the
split's store uploaded to the card at the start of each evaluation pass.
Inclusive, from the run's segment with the program's tracer on and no
profiler (``harness.py``), over that segment's passes.  The upload is a
pageable copy that holds the host until it ends; behind a queue of
launches it also holds the host's wait for them."""

from vqabench.trace import span_seconds


def read(m):
    seconds = span_seconds(m, "eval.upload")
    return None if seconds is None else 1e3 * seconds / m.traced.dispatches
