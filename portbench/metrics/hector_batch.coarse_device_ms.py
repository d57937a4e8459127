"""Device milliseconds a call of ``match_pyramid_batched`` in its coarse
levels (the span ``hector.coarse``, read from the program): the windowed
sampler's gathers, the normal systems and the 3x3 solves of every coarse
iteration."""

from portbench import spans


def read(run):
    return spans.per_call_ms(run, "hector.coarse", device=True)
