"""One reader a metric, each in ``<metric name>.py``, found by the name in
``BENCHMARK.json``.  A reader is ``read(run)``: it takes the run's record
(``portbench.run.Record``: set-up and window times, calls, pairs a call,
the context, and with ``--trace 1`` the ``portbench.trace.Trace`` of the
traced calls) and returns a number, or None when it finds nothing to read,
and the harness then leaves the metric out of the result line."""
