"""PyTorch/CUDA port of the MapReduce-Apriori system in ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``kernels``, ``data``, ``serve``, ``distributed``, ``launch``,
and the dense LM's ``configs``, ``models`` and ``analytics``) and imports
neither JAX nor ``repro``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
