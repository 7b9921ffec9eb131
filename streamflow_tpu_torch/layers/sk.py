"""SKFlow large-kernel block (port of streamflow_tpu/layers/sk.py::SKBlock,
reference PCBlock4_Deep_nopool_res, core/update.py:12-36).

FFN(1.5x) residual -> depthwise convs of sizes ``k_conv`` (canonical
(1, 15)) each as a gelu residual -> pointwise gelu residual -> FFN(1.5x)
projection. The hidden width is exactly int(1.5 * c_in): the JAX package's
lane padding and its ``lax.cond`` layout shield are TPU workarounds and
are not ported.

Two layouts of the same function, chosen by ``dw_impl`` as in the JAX
kernel path:

- default (every ``dw_impl`` but ``'pallas'``; JAX's ``xla_cond`` edge-fused
  layout, layers/sk.py:264-314): K2 ``ffn_pair_k1`` (first pair + the k=1
  stage), the kxk depthwise conv alone (``F.conv2d(groups=C)``, no bias),
  then K2 ``dwres_pw_ffn_pair`` (conv bias + residual gelu, pw stage,
  second pair); k_conv must be (1, k);
- ``'pallas'`` (layers/sk.py:315-330, 472-490): K2 ``ffn_pair`` (first
  pair, residual), K5 ``dw_chain`` (every k=1 stage and the kxk conv, each
  as a gelu residual), K2 ``pw_ffn_pair`` (pw stage + second pair); k_conv
  must be (1,)*n + (k,).

On a CPU tensor the kernel wrappers run their plain versions, so the CPU
tests check the same decomposition the card runs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamflow_tpu_torch.layers.common import cast
from streamflow_tpu_torch.ops.kernels.dw_chain import dw_chain
from streamflow_tpu_torch.ops.kernels.ffn_pair import (dwres_pw_ffn_pair,
                                                       ffn_pair, ffn_pair_k1,
                                                       pw_ffn_pair)


def _ffn(c_in: int, hidden: int, out: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(c_in, hidden, 1), nn.GELU(),
                         nn.Conv2d(hidden, out, 1))


class SKBlock(nn.Module):
    def __init__(self, c_in: int, out_dim: int,
                 k_conv: Sequence[int] = (1, 15), dw_impl: str = "auto"):
        super().__init__()
        hidden = int(1.5 * c_in)
        self.k_conv = tuple(k_conv)
        self.chain = dw_impl == "pallas"
        self.ffn1 = _ffn(c_in, hidden, c_in)
        self.conv_list = nn.ModuleList(
            nn.Conv2d(c_in, c_in, k, padding=k // 2, groups=c_in)
            for k in self.k_conv)
        self.pw = nn.Conv2d(c_in, c_in, 1)
        self.ffn2 = _ffn(c_in, hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C_in) -> (B, H, W, out_dim)."""
        ks = self.k_conv
        if self.chain and any(k != 1 for k in ks[:-1]):
            raise NotImplementedError(
                f"the dw_impl='pallas' layout takes k_conv (1,)*n + (k,), "
                f"got {ks}")
        if not self.chain and not (len(ks) == 2 and ks[0] == 1
                                   and ks[1] > 1):
            raise NotImplementedError(
                f"the default layout takes k_conv (1, k), got {ks}; "
                f"dw_impl='pallas' takes (1,)*n + (k,)")

        def w(conv):  # (out, in, 1, 1) -> (out, in), in x's dtype
            return cast(conv.weight.reshape(conv.weight.shape[:2]), x)

        def b(conv):
            return cast(conv.bias, x)

        f1a, f1b, f2a, f2b = (self.ffn1[0], self.ffn1[2], self.ffn2[0],
                              self.ffn2[2])
        if self.chain:
            x = ffn_pair(x.contiguous(), w(f1a), b(f1a), w(f1b), b(f1b))
            x = dw_chain(x, tuple(cast(m.weight, x) for m in self.conv_list),
                         tuple(b(m) for m in self.conv_list), ks)
            return pw_ffn_pair(x, w(self.pw), b(self.pw), w(f2a), b(f2a),
                               w(f2b), b(f2b))

        k1, dw = self.conv_list
        x = ffn_pair_k1(x.contiguous(), w(f1a), b(f1a), w(f1b), b(f1b),
                        cast(k1.weight.reshape(-1), x), b(k1))
        y = x.permute(0, 3, 1, 2)
        if dw.kernel_size[0] > 7:
            # cuDNN's bf16 depthwise kxk is several times faster on NCHW
            # than on a channels-last view for k=15, and slower for k=7
            # (H100 80GB HBM3, 700 W: (3, 324, 55, 128) k=15 0.77 ms with
            # both copies vs 2.64 ms; (3, 640, 55, 128) k=7 0.68 vs 0.27)
            y = y.contiguous()
        y = F.conv2d(y, cast(dw.weight, x), None, 1, dw.padding, 1,
                     dw.groups)
        y = y.permute(0, 2, 3, 1).contiguous()
        return dwres_pw_ffn_pair(x, y, b(dw), w(self.pw), b(self.pw),
                                 w(f2a), b(f2a), w(f2b), b(f2b))
