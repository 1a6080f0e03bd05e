"""place_encode_s (s): the runner's place in set-up before the engine: the
digests, the encoded-dataset cache, the dense remap and the host encode
(``TorchRunner.place``), the program's span
``repro_torch.runner.place.encode`` (``perfbench/spans.py``). Nothing where
the program has no such span."""

from perfbench.spans import seconds_a_call


def read(r):
    return seconds_a_call("repro_torch.runner.place.encode")
