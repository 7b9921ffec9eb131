"""ffn_pair_roofline: the least time the card could take for a request's
FFN pair work (``counts/kernels.py``: every SK block's two pairs and
pointwise stage and every Twins MLP, at the bf16 peak and the memory rate)
over the device time of the kernels that do it, in %. Layer: kernels (K2,
csrc/ffn_pair.cu, every form). Moves flows_per_s.

KERNELS: substrings of the kernel names that implement the work; a later
change of kernel adds its name here, the count stays."""

from sfbench.counts.kernels import work
from sfbench.counts.profile import bound_s

KERNELS = ("ffn_pair",)


def read(view):
    cell = view.cell
    s = view.trace.device_s(lambda n: any(k in n for k in KERNELS))
    if s <= 0 or not view.units:
        return None
    least = bound_s(*work("ffn_pair", cell.reference, cell.config,
                          cell.traffic))
    return 100.0 * least * view.units / s
