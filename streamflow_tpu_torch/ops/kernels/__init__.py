"""Python wrappers of the port's hand-written CUDA kernels, one module per
kernel. Each wrapper launches its kernel for CUDA tensors (or raises) and
runs the kernel's plain PyTorch version for CPU tensors; there is no other
path between the two.

``LAUNCHES`` counts, per kernel, the launches made through the wrappers
(plain-version calls are not counted); ``reset_launches`` zeroes it. The
last two, K1's work-split modes (``corr_lookup_probe``) and the
channel-major FFN pair (``ffn_pair_cmajor``), run in the probe tools
only.

Gradients: K3 has a backward kernel of its own (B5, in
``flash_attention``). K1, K2 and K4-K8 differentiate like the JAX
package's ``custom_vjp`` wrappers of their Pallas kernels: the forward is
the kernel, the backward is autograd of a differentiable PyTorch composite of
the same function recomputed from the saved inputs (``CompositeVJP``).
The JAX package's backwards of these kernels are XLA, not Pallas, so this
backward is ordinary PyTorch, not a plain version standing in for a kernel.
"""

import torch

LAUNCHES = {"corr_lookup": 0, "ffn_pair": 0, "flash_attention": 0,
            "flash_attention_bwd": 0, "lga_attention": 0, "dw_chain": 0,
            "dw_banded_mxu": 0, "dw_banded_mxu_t": 0, "sk_chain_banded": 0,
            "corr_lookup_probe": 0, "ffn_pair_cmajor": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class CompositeVJP(torch.autograd.Function):
    """forward: ``kernel(*args)``; backward: the vector-Jacobian product of
    ``composite(*args)``, recomputed from the saved ``args`` (tensors or
    None). Gradients flow to the tensor arguments that require them."""

    @staticmethod
    def forward(ctx, kernel, composite, *args):
        ctx.composite = composite
        ctx.save_for_backward(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad):
        args = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(n) if a is not None else None
                   for a, n in zip(args, needs)]
            out = ctx.composite(*ins)
            wrt = [a for a, n in zip(ins, needs) if n]
            got = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
        return (None, None, *(next(got) if n else None for n in needs))


def with_composite_vjp(kernel, composite, *args):
    """``kernel(*args)``, differentiable through ``composite`` when autograd
    records and a tensor argument requires a gradient."""
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in args):
        return CompositeVJP.apply(kernel, composite, *args)
    return kernel(*args)
