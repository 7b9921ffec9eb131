"""Operations and bytes of the work behind each roofline share, from the
configuration's shapes alone (the arithmetic of the kernel checks the
port's chip smoke test runs: 2 flops a multiply-add, each input byte read
once and each output byte written once, in the compute type).

The work is counted the same whatever layout or kernel implements it,
from the shapes that the model's reference lists (``sk_blocks``,
``mlps``):

- ``ffn_pair``: each SK block's two FFN pairs (c -> 1.5c -> c, then
  c -> 1.5c -> out) and its pointwise stage (c -> c), and each other FFN
  pair of the model (a Twins block's MLP, c -> 4c -> c); bytes: the
  block's input and output and the weights. The depthwise k = 1 stage,
  the norms and the gelu residuals are elementwise and not counted.
- ``dwconv``: each SK block's k x k depthwise convolution (k > 1); bytes:
  its input, output and weights.

``work(name, ref, cfg, traffic)`` -> (flops, bytes) of one request of an
inference cell, ``ref`` the model's reference module (``cell.reference``).
"""

from __future__ import annotations

from typing import Dict, Tuple

BF16 = 2


def _pair(c: int, hid: int, co: int, rows: int) -> Tuple[float, float]:
    flops = 2.0 * rows * (c * hid + hid * co)
    return flops, BF16 * (c * hid + hid * co + hid + co)


def _blocks(ref, cfg, traffic):
    hh, ww = traffic["padded"]
    return ref.sk_blocks(cfg, traffic["batch"], traffic["frames"] - 1,
                         hh // 8, ww // 8)


def ffn_pair_work(ref, cfg, traffic) -> Tuple[float, float]:
    iters = traffic["iters"]
    flops = nbytes = 0.0
    for c, co, _, rows in _blocks(ref, cfg, traffic):
        hid = int(1.5 * c)
        f1, w1 = _pair(c, hid, c, rows)
        f2, w2 = _pair(c, hid, co, rows)
        flops += iters * (f1 + f2 + 2.0 * rows * c * c)
        nbytes += iters * (w1 + w2 + BF16 * (c * c + c)
                           + BF16 * rows * (c + co))
    for c, hid, rows in ref.mlps(cfg, traffic["batch"], traffic["frames"],
                                 *traffic["padded"]):
        fl, wb = _pair(c, hid, c, rows)
        flops += fl
        nbytes += wb + BF16 * 2 * rows * c
    return flops, nbytes


def dwconv_work(ref, cfg, traffic) -> Tuple[float, float]:
    iters = traffic["iters"]
    flops = nbytes = 0.0
    for c, _, k, rows in _blocks(ref, cfg, traffic):
        flops += iters * 2.0 * k * k * rows * c
        nbytes += iters * BF16 * (2 * rows * c + k * k * c + c)
    return flops, nbytes


WORK = {"ffn_pair": ffn_pair_work, "dwconv": dwconv_work}


def work(name: str, ref, cfg: Dict, traffic: Dict) -> Tuple[float, float]:
    return WORK[name](ref, cfg, traffic)
