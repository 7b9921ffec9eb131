"""dwconv_roofline: the least time the card could take for a request's
SK depthwise k x k convolutions (``counts/kernels.py``) over the device
time of the kernels that run them, in %. Layer: kernels (PyTorch's
depthwise conv in the default SK layout; K5-K8 dw_chain, dw_banded,
sk_chain in the others). Moves flows_per_s.

KERNELS: substrings of the kernel names that implement the work; a later
change of kernel adds its name here, the count stays."""

from sfbench.counts.kernels import work
from sfbench.counts.profile import bound_s

# PyTorch's depthwise kernels: conv_depthwise2d on NCHW (the 15x15),
# conv2d_c1_k1_nhwc on a channels-last view (the 7x7); K5-K8
KERNELS = ("conv_depthwise2d", "conv2d_c1_k1_nhwc", "dw_chain", "dw_banded",
           "sk_chain")


def read(view):
    cell = view.cell
    s = view.trace.device_s(lambda n: any(k in n for k in KERNELS))
    if s <= 0 or not view.units:
        return None
    least = bound_s(*work("dwconv", cell.reference, cell.config,
                          cell.traffic))
    return 100.0 * least * view.units / s
