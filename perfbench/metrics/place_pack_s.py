"""place_pack_s (s): the engine's place in set-up: the store's transaction
tensors on the host (``transaction_inputs``; for ``packed_bitmap`` the bit
packing), the program's span ``repro_torch.engine.place.pack``
(``perfbench/spans.py``). Nothing where the program has no such span."""

from perfbench.spans import seconds_a_call


def read(r):
    return seconds_a_call("repro_torch.engine.place.pack")
