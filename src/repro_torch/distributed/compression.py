"""Int8 gradient compression with error feedback (PyTorch port of the JAX
package's ``distributed/compression.py``).

On a multi-host mesh the cross-host gradient all-reduce is the scarcest
bandwidth; quantizing each parameter's gradient to int8 with a per-tensor
scale cuts that payload 2x vs bf16 (4x vs f32) at the cost of quantization
noise, which error feedback (carrying the residual into the next step)
removes to first order.  As in the reference, the transform is applied to
the gradients inside the train step (numerically what compressing the
collective's payload would do) and the bfloat16 EF state is part of the
optimizer state tree.  ``torch.round`` rounds half to even, as
``jnp.round`` does; the scale is the maximum times float32(1/127) and the
residual rounds once, as XLA computes both in the reference's jitted step
(a product with the constant's reciprocal, a fused multiply-add), so both
packages give the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.models.params import ParamSpec, spec, tree_map


def ef_abstract(params_abstract):
    def one(s: ParamSpec):
        return spec(s.shape, s.axes, dtype=torch.bfloat16, init="zeros")

    return tree_map(one, params_abstract)


_INV_127 = float(torch.tensor(1 / 127.0, dtype=torch.float32))


def _g32(g, ef):
    return g.float() + ef.float()


def _scales(grads, ef_state, cfg):
    """Each leaf's per-tensor scale (as a 0-d tensor), shared across the
    layers the reference stacks into one tensor."""
    amax = {}

    def walk(g, e, path):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], e[k], path + (k,))
        else:
            amax[path] = torch.max(torch.abs(_g32(g, e)))

    walk(grads, ef_state, ())
    from repro_torch.models.transformer import stacked_layers

    for group in stacked_layers(cfg):
        for path in [p for p in amax if p[:2] == ("blocks", str(group[0]))]:
            peers = [("blocks", str(i)) + path[2:] for i in group]
            shared = torch.stack([amax[q] for q in peers]).max()
            for q in peers:
                amax[q] = shared
    # max / 127 as the reference's jitted step computes it: XLA turns the
    # division by a constant into a product with its float32 reciprocal.
    return {p: torch.clamp(a, min=1e-12) * _INV_127 for p, a in amax.items()}


def compress_grads(grads, ef_state, cfg):
    """Quantize grads to int8 (per-tensor scale) + error feedback.

    Returns (dequantized grads, new ef_state). The int8 tensor is what a
    custom collective would move across hosts.  ``cfg`` (the model's
    ``ModelConfig``) is required, unlike the reference's: the port keeps
    one tree per layer, and the layers the reference scans must share one
    scale per leaf, as its stacked leaf has one
    (``transformer.stacked_layers``).  Leaves outside ``blocks`` keep their
    own scale.
    """
    scales = _scales(grads, ef_state, cfg)

    def walk(g, e, path):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], e[k], path + (k,)) for k in g}
            return ({k: a for k, (a, _) in pairs.items()},
                    {k: b for k, (_, b) in pairs.items()})
        g32, scale = _g32(g, e), scales[path]
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        # The residual g32 - q * scale rounds once, as the fused
        # multiply-add of the reference's jitted step computes it: the
        # float64 product is exact (8 + 24 bits), and so is the difference.
        res = (g32.double() - q.double() * scale.double()).float()
        return deq.to(g.dtype), res.to(e.dtype)

    return walk(grads, ef_state, ())
