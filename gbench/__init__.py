"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``): served
graph analytics through ``GraphService``. ``python3 gbench/run.py --help``
and ``gbench/README.md`` say how to run and extend it."""
