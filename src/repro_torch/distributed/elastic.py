"""Elastic recovery: rebuild a smaller counting mesh after ranks are lost
(PyTorch port of the JAX package's ``distributed/elastic.py``).

One rank drives one device, so a lost device is a lost rank.  Level
checkpoints hold whole (unsharded) state, so elasticity reduces to: build
the largest usable mesh over the surviving ranks and resume.  Counts are
identical on every mesh shape, so elasticity never changes results, only
how much memory and parallelism the resumed run gets.  The miner drives it
(``FrequentItemsetMiner._elastic_rebuild``).

The LM half of the reference module (``elastic_mesh``, ``resume``) belongs
to the LM scaffolding and is not ported.
"""

from __future__ import annotations

from typing import List, Sequence

from repro_torch.launch.mesh import mesh_of_ranks


def surviving_devices(mesh, lost: int) -> List[int]:
    """The ranks left after ``lost`` die (simulated: the tail of the mesh's
    rank grid is the casualty set, so reruns are deterministic)."""
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    if lost >= len(ranks):
        return []
    return ranks[: len(ranks) - lost]


def elastic_data_cand_mesh(ranks: Sequence[int], want_cand: bool = False,
                           device="cuda"):
    """Largest usable counting mesh on the surviving ranks.

    ``want_cand=False`` rebuilds the 1-D ``data`` mesh over every survivor.
    ``want_cand=True`` rebuilds a 2-D ``data x cand`` grid: ``cand`` takes
    the largest power of two not above sqrt(n) that divides ``n``
    (``launch.mesh.make_data_cand_mesh``'s default), shrinking candidate
    parallelism before data parallelism.  Building it is collective: every
    rank of the world calls this, the lost ones included.
    """
    ranks = list(ranks)
    n = len(ranks)
    if n == 0:
        raise ValueError("no surviving ranks to rebuild a mesh on")
    if not want_cand:
        return mesh_of_ranks(ranks, (n,), ("data",), device)
    n_cand = 1
    while n_cand * 2 * n_cand * 2 <= n and n % (n_cand * 2) == 0:
        n_cand *= 2
    n_data = n // n_cand
    return mesh_of_ranks(ranks[: n_data * n_cand], (n_data, n_cand),
                         ("data", "cand"), device)
