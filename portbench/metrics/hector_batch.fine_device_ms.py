"""Device milliseconds a call of ``match_pyramid_batched`` in its finest
level (the span ``hector.fine``, read from the program): the grid's bf16
cast and the ``hector_gn`` launch, ``iterations_finest`` iterations."""

from portbench import spans


def read(run):
    return spans.per_call_ms(run, "hector.fine", device=True)
