"""The benchmark of the PyTorch and CUDA port, ``tpuslam_torch``: see
``portbench/README.md`` and ``BENCHMARK.json`` at the repo's root."""
