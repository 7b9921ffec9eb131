"""Python wrappers of the port's hand-written CUDA kernels, one module per
kernel. Each wrapper launches its kernel for CUDA tensors (or raises) and
runs the kernel's plain PyTorch version for CPU tensors; there is no other
path between the two.

``LAUNCHES`` counts, per kernel, the launches made through the wrappers
(plain-version calls are not counted); ``reset_launches`` zeroes it.
"""

LAUNCHES = {"corr_lookup": 0, "ffn_pair": 0, "flash_attention": 0,
            "lga_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
