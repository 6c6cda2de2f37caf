"""Host milliseconds per optimizer step inside the port's ``train.update``
span: the autoencoder's optimizer update of the params. Inclusive of the
spans inside it, read in the run's segment with the program's tracer on
and no profiler (``harness.py``), over that segment's optimizer steps.
In a card-paced cell the span also holds the host's waits in a full
launch queue, so there it reads the card's pace, not the host's issue
alone."""

from vqabench.trace import span_seconds


def read(m):
    seconds = span_seconds(m, "train.update")
    return None if seconds is None else 1e3 * seconds / m.traced.steps
