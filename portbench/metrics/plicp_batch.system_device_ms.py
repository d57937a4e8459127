"""Device milliseconds a call of ``plicp_batch`` in its Gauss-Newton
systems (the span ``plicp.system``, read from the program): the weights,
the Jacobian, H and g over [N, B, 3, 3], the solve, the new pose and the
convergence test, every pass."""

from portbench import spans


def read(run):
    return spans.per_call_ms(run, "plicp.system", device=True)
