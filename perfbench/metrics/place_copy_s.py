"""place_copy_s (s): the engine's place in set-up: the copy of the store's
transaction tensors to the device, the program's span
``repro_torch.engine.place.copy`` (``perfbench/spans.py``). Nothing where
the program has no such span."""

from perfbench.spans import seconds_a_call


def read(r):
    return seconds_a_call("repro_torch.engine.place.copy")
