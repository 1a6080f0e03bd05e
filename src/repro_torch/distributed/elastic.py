"""Elastic recovery: rebuild a smaller counting mesh after ranks are lost
(PyTorch port of the JAX package's ``distributed/elastic.py``).

One rank drives one device, so a lost device is a lost rank.  Level
checkpoints hold whole (unsharded) state, so elasticity reduces to: build
the largest usable mesh over the surviving ranks and resume.  Counts are
identical on every mesh shape, so elasticity never changes results, only
how much memory and parallelism the resumed run gets.  The miner drives it
(``FrequentItemsetMiner._elastic_rebuild``).

For the LM, ``elastic_mesh`` rebuilds the largest ``data x model`` mesh
on the survivors, keeping the model axis and shedding data parallelism,
and ``resume`` restores a snapshot onto it, each leaf placed as the
current mesh's rules dictate whatever mesh saved it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.distributed.sharding import ShardingRules, default_rules
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


def elastic_mesh(ranks: Optional[Sequence[int]] = None, model_axis: int = 16,
                 axis_names: Tuple[str, str] = ("data", "model"),
                 device="cuda"):
    """Largest (data, model) mesh on the surviving ranks (default: the
    whole world).

    Keeps the model axis at ``model_axis`` if possible (the TP degree is
    what the layout is tuned for, so data parallelism is shed first);
    otherwise halves it until it divides the survivors.  Building it is
    collective: every rank of the world calls this.
    """
    if ranks is None:
        from repro_torch.launch.mesh import _world

        ranks = range(_world(device)[1])
    ranks = list(ranks)
    if not ranks:
        raise ValueError("no surviving ranks to rebuild a mesh on")
    data, model = elastic_grid(len(ranks), model_axis)
    return mesh_of_ranks(ranks[: data * model], (data, model), axis_names,
                         device)


def elastic_grid(n: int, model_axis: int = 16) -> Tuple[int, int]:
    """``elastic_mesh``'s (data, model) grid on ``n`` ranks."""
    model = model_axis
    while model > 1 and n % model:
        model //= 2
    return n // model, model


def resume(ckpt_dir: str, abstract_state, mesh=None,
           rules: Optional[ShardingRules] = None, step: Optional[int] = None,
           device="cuda"):
    """Restore ``abstract_state`` (a tree of ParamSpec) onto ``mesh``
    (default: ``elastic_mesh()``) under ``rules`` (default:
    ``default_rules()``).

    Returns (state_tree, step, extra) with every leaf a DTensor placed as
    the current mesh dictates, whatever mesh saved it.
    """
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.models.params import shape_structs, shardings

    mesh = mesh if mesh is not None else elastic_mesh(device=device)
    rules = rules or default_rules()
    sh = shardings(abstract_state, mesh, rules.rules)
    out = ckpt.restore(ckpt_dir, shape_structs(abstract_state), step=step,
                       device=device, shardings=sh, mesh=mesh)
    if out is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return out
