"""Counting meshes over ``torch.distributed`` ranks (PyTorch port of the JAX
package's ``launch/mesh.py``).

One rank drives one device, so a mesh is a grid of *ranks*: PyTorch's own
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
``("data",)`` or ``("data", "cand")``, ranks laid out row-major (``rank =
d * n_cand + c``).  A constructor called with no process group yet makes a
one-rank group on a free local TCP port first (NCCL on a CUDA device, gloo
on the CPU), so ``FrequentItemsetMiner(mesh=make_data_mesh())`` works in a
plain script on one card.  Building a mesh creates its sub-groups, which is
collective: every rank of the world calls the constructor, in the same order.

The LM meshes have the axes ``("data", "model")``, or ``("pod", "data",
"model")`` across pods: ``make_production_mesh`` is the reference's
production grid, (16, 16) or (2, 16, 16) ranks, and ``make_host_mesh`` a
``data x model`` grid over whatever ranks exist.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _world(device):
    """The world size, after making a one-rank group when none exists; a
    group whose backend cannot carry ``device``'s tensors raises."""
    import torch.distributed as dist

    from repro_torch.core.runtime.engine import resolve_device
    from repro_torch.distributed.ctx import init_group
    from repro_torch.launch.multihost import find_free_port

    dev = resolve_device(device)
    if not dist.is_initialized():
        init_group(f"127.0.0.1:{find_free_port()}", 1, 0, device=dev)
    elif dev.type == "cpu" and dist.get_backend() not in ("gloo", "fake"):
        raise ValueError(f"a CPU mesh needs a gloo process group (or the "
                         f"dry run's fake one), this one is "
                         f"{dist.get_backend()}")
    return dev.type, dist.get_world_size()


def mesh_of_ranks(ranks: Sequence[int], shape, names, device="cuda"):
    """A ``DeviceMesh`` over ``ranks`` (row-major in ``shape``)."""
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(torch.device(device).type, grid,
                      mesh_dim_names=tuple(names))


def make_data_mesh(n_shards: Optional[int] = None, device="cuda"):
    """1-D data-parallel mesh for ``ShardedRunner``: transactions shard over
    ``data``, candidates replicate.  ``n_shards`` defaults to the world."""
    device_type, total = _world(device)
    n = n_shards or total
    if n > total:
        raise ValueError(f"data mesh of {n} shards needs {n} ranks but only "
                         f"{total} exist (launch more processes)")
    return mesh_of_ranks(range(n), (n,), ("data",), device_type)


def make_data_cand_mesh(n_data: Optional[int] = None,
                        n_cand: Optional[int] = None, device="cuda"):
    """2-D ``data x cand`` mesh for candidate-axis sharding: transactions
    shard over ``data`` (replicated over ``cand``), each counting wave's
    candidate rows over ``cand`` (replicated over ``data``).

    With no sizes given, ``cand`` takes the largest power of two not above
    sqrt(world) that divides it (8 ranks -> 4x2 data x cand).
    Oversubscription fails here with the requested grid spelled out.
    """
    device_type, total = _world(device)
    if n_cand is None:
        if n_data is not None:
            n_cand = max(1, total // n_data)
        else:
            n_cand = 1
            while n_cand * 2 * n_cand * 2 <= total and total % (n_cand * 2) == 0:
                n_cand *= 2
    if n_data is None:
        n_data = max(1, total // n_cand)
    if n_data * n_cand > total:
        raise ValueError(
            f"data x cand mesh {n_data}x{n_cand} needs {n_data * n_cand} "
            f"ranks but only {total} exist (launch more processes)")
    return mesh_of_ranks(range(n_data * n_cand), (n_data, n_cand),
                         ("data", "cand"), device_type)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The LM's production mesh over the world's first ranks: ``data x
    model`` (16, 16), or ``pod x data x model`` (2, 16, 16) across pods.
    A smaller world fails here with the grid spelled out."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    # Checked before ``_world`` would make a one-rank group to fail in.
    total = dist.get_world_size() if dist.is_initialized() else 1
    if need > total:
        grid = " x ".join(f"{a} {n}" for a, n in zip(names, shape))
        raise ValueError(f"production mesh {grid} needs {need} ranks but "
                         f"only {total} exist (launch more processes)")
    device_type, _ = _world(device)
    return mesh_of_ranks(range(need), shape, names, device_type)


def make_host_mesh(model_axis: int = 1, device="cuda"):
    """``data x model`` mesh over every rank of the world (tests, one
    host): ``model_axis`` ranks to a model group."""
    device_type, total = _world(device)
    if total % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world's {total} ranks")
    return mesh_of_ranks(range(total), (total // model_axis, model_axis),
                         ("data", "model"), device_type)
