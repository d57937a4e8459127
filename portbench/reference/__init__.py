"""The plain references that decide ``correct``: plain PyTorch, no kernel,
nothing of the program under test (``tpuslam_torch``) and nothing of JAX.

Each function takes the inputs the benchmark made (points, masks and
initial guesses, the same tensors the program was handed) and computes in
their dtype: float64 for the reference, bfloat16 for the lower-precision
control.  The correspondence search is the exhaustive one the matchers'
contracts state, as a dense ``[P, B, B']`` distance matrix, so callers pass
blocks of pairs that fit the device.
"""
