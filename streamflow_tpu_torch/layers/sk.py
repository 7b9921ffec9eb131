"""SKFlow large-kernel block (port of streamflow_tpu/layers/sk.py::SKBlock,
reference PCBlock4_Deep_nopool_res, core/update.py:12-36).

FFN(1.5x) residual -> depthwise convs of sizes ``k_conv`` (canonical
(1, 15)) each as a gelu residual -> pointwise gelu residual -> FFN(1.5x)
projection. The hidden width is exactly int(1.5 * c_in): the JAX package's
lane padding and its ``lax.cond`` layout shield are TPU workarounds and
are not ported.

Layouts of the same function, chosen by ``dw_impl`` as in the JAX
kernel path:

- default (every ``dw_impl`` not named below; JAX's ``xla_cond``
  edge-fused layout, layers/sk.py:264-314): K2 ``ffn_pair_k1`` (first pair
  + the k=1 stage), the kxk depthwise conv alone (``F.conv2d(groups=C)``,
  no bias), then K2 ``dwres_pw_ffn_pair`` (conv bias + residual gelu, pw
  stage, second pair); k_conv must be (1, k);
- the pair layouts, ``'pallas'`` and the banded family ``'banded'``,
  ``'banded_mxu'``, ``'banded_mxu_t'``, ``'banded_chain'``
  (layers/sk.py:315-365, 472-490): K2 ``ffn_pair`` (first pair, residual),
  the dw stack, K2 ``pw_ffn_pair`` (pw stage + second pair). Only the dw
  stack differs: ``'pallas'`` K5 ``dw_chain`` (k_conv (1,)*n + (k,));
  ``'banded_chain'`` K8 ``sk_chain_banded`` for such k_conv, else the
  stages as ``'banded_mxu'``; ``'banded_mxu'`` / ``'banded_mxu_t'`` /
  ``'banded'`` each stage as x = gelu(x + y), y = x w + b for k=1 and K6
  ``dw_banded_mxu`` / K7 ``dw_banded_mxu_t`` / the ``dw_banded_xla``
  composite for k > 1. JAX's TPU-only conditions for these kernels
  (backend, C % 128, VMEM estimates) are not ported.

On a CPU tensor the kernel wrappers run their plain versions, so the CPU
tests check the same decomposition the card runs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamflow_tpu_torch.layers.common import cast, gelu
from streamflow_tpu_torch.ops.kernels.dw_banded import (dw_banded_mxu,
                                                        dw_banded_mxu_t,
                                                        dw_banded_xla,
                                                        sk_chain_banded)
from streamflow_tpu_torch.ops.kernels.dw_chain import dw_chain
from streamflow_tpu_torch.ops.kernels.ffn_pair import (dwres_pw_ffn_pair,
                                                       ffn_pair, ffn_pair_k1,
                                                       pw_ffn_pair)


# the dw_impl values of the pair layouts, and the per-stage conv of each
_PAIR_LAYOUTS = ("pallas", "banded", "banded_mxu", "banded_mxu_t",
                 "banded_chain")
_STAGE_CONV = {"banded": dw_banded_xla, "banded_mxu": dw_banded_mxu,
               "banded_chain": dw_banded_mxu, "banded_mxu_t": dw_banded_mxu_t}


def _ffn(c_in: int, hidden: int, out: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(c_in, hidden, 1), nn.GELU(),
                         nn.Conv2d(hidden, out, 1))


class SKBlock(nn.Module):
    def __init__(self, c_in: int, out_dim: int,
                 k_conv: Sequence[int] = (1, 15), dw_impl: str = "auto"):
        super().__init__()
        hidden = int(1.5 * c_in)
        self.k_conv = tuple(k_conv)
        self.layout = dw_impl if dw_impl in _PAIR_LAYOUTS else "edge"
        self.ffn1 = _ffn(c_in, hidden, c_in)
        self.conv_list = nn.ModuleList(
            nn.Conv2d(c_in, c_in, k, padding=k // 2, groups=c_in)
            for k in self.k_conv)
        self.pw = nn.Conv2d(c_in, c_in, 1)
        self.ffn2 = _ffn(c_in, hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C_in) -> (B, H, W, out_dim)."""
        ks = self.k_conv
        chain_ks = all(k == 1 for k in ks[:-1]) and ks[-1] > 1
        if self.layout == "pallas" and not chain_ks:
            raise NotImplementedError(
                f"the dw_impl='pallas' layout takes k_conv (1,)*n + (k,), "
                f"got {ks}")
        if self.layout == "edge" and not (len(ks) == 2 and ks[0] == 1
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
        if self.layout != "edge":
            x = ffn_pair(x.contiguous(), w(f1a), b(f1a), w(f1b), b(f1b))
            ws = tuple(cast(m.weight, x) for m in self.conv_list)
            bs = tuple(b(m) for m in self.conv_list)
            if self.layout == "pallas":
                x = dw_chain(x, ws, bs, ks)
            elif self.layout == "banded_chain" and chain_ks:
                x = sk_chain_banded(x, ws, bs, ks)
            else:
                conv = _STAGE_CONV[self.layout]
                for wk, bk, k in zip(ws, bs, ks):
                    y = x * wk.reshape(-1) + bk if k == 1 else conv(x, wk, bk)
                    x = gelu(x + y)
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
