"""A dense block's parameters as the BN-folded stacks its kernels take: the
port of ``dmmfods_tpu/ops/pallas/dense_block.py::fold_block_params[_jnp]``.
"""

from __future__ import annotations

import torch

from .fused import fold_bn


def fold_block_params(block):
    """An eval ``DenseBlock``'s layers -> padded, BN-folded stacks, float32.

    Returns a dict of tensors on the block's device, with ``L`` layers,
    ``K = bn_size * growth``, ``C_max = c0 + L * growth``:

      g1, b1: (L, C_max)          folded norm1, zero beyond each layer's width
      w1:     (L, C_max, K)       conv1 as (in, out), zero beyond the width
      g2, b2: (L, K)              folded norm2
      w3:     (L, 3, 3, K, growth) conv2 as (ky, kx, in, out)

    The layouts are the JAX function's, so the two compare directly.
    """
    layers = list(block.children())
    first = layers[0]
    c0 = first.conv1.in_channels
    k = first.conv1.out_channels
    growth = first.conv2.out_channels
    n = len(layers)
    c_max = c0 + n * growth
    device = first.conv1.weight.device
    g1 = torch.zeros(n, c_max, device=device)
    b1 = torch.zeros(n, c_max, device=device)
    w1 = torch.zeros(n, c_max, k, device=device)
    g2 = torch.empty(n, k, device=device)
    b2 = torch.empty(n, k, device=device)
    w3 = torch.empty(n, 3, 3, k, growth, device=device)
    with torch.no_grad():
        for l, layer in enumerate(layers):
            width = c0 + l * growth
            n1, n2 = layer.norm1, layer.norm2
            g1[l, :width], b1[l, :width] = fold_bn(
                n1.weight, n1.bias, n1.running_mean, n1.running_var, n1.eps)
            w1[l, :width] = layer.conv1.weight.reshape(k, width).t()
            g2[l], b2[l] = fold_bn(n2.weight, n2.bias, n2.running_mean,
                                   n2.running_var, n2.eps)
            w3[l] = layer.conv2.weight.permute(2, 3, 1, 0)
    return {"g1": g1, "b1": b1, "w1": w1, "g2": g2, "b2": b2, "w3": w3}
