"""One driver a program entry point, each in ``<entry>.py``, found by the
``entry`` key of a configuration.  A driver module gives:

- ``COUNTERS``: the program's own counters (a dict of ints), read around
  the window;
- ``passes(params)``: the fixed passes a call makes, for the work line and
  the roofline counts;
- ``program(params, bag)``: the system under test, as ``call(a, b)`` that
  runs pairs [a, b) of the bag and returns its outputs by name;
- ``reference(params, bag, a, b, dtype)``: the plain reference's outputs
  for the same pairs, computed in ``dtype``;
- ``compare(out, ref)``: the numbers that decide ``correct``, by name;
- optionally ``levels(params)``: the levels of a multi-level matcher,
  finest first, as (grid cells, iterations), for its roofline count.
"""
