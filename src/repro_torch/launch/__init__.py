"""Launchers of the PyTorch port (``python -m repro_torch.launch.<name>``):
``serve`` (the mining service) and ``multihost`` (a process-spanning mine
with elastic recovery), and ``mesh``, the counting meshes over
``torch.distributed`` ranks."""

from repro_torch.launch import mesh, multihost

__all__ = ["mesh", "multihost"]
