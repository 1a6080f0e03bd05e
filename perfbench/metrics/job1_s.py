"""job1_s (s): the runner's Job1 in set-up: the device histogram of the padded
matrix and its fetch (``TorchRunner.job1``), the program's span
``repro_torch.runner.job1`` (``perfbench/spans.py``). Nothing where the
program has no such span."""

from perfbench.spans import seconds_a_call


def read(r):
    return seconds_a_call("repro_torch.runner.job1")
