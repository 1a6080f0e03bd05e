"""The benchmark of the PyTorch and CUDA port (``repro_torch``): support
counting jobs over a resident basket database, run one cell at a time by
``run.py``.  See ``harness.py`` for how a cell is found and run."""
