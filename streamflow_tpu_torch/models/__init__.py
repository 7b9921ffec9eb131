"""Model registry of the port (counterpart of streamflow_tpu.models)."""

import torch

from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.models.streamflow import StreamFlow


def create_model(name: str, cfg=None, device="cuda", train: bool = False,
                 **kwargs):
    """Build a model by name ('streamflow', the one the port has so far) on
    ``device``: the card unless the caller asks for ``device="cpu"``; a
    CUDA device without a card raises. ``kwargs`` build the config when
    ``cfg`` is None.

    ``train=False``: for inference, parameters in the compute dtype
    (bf16 under ``mixed_precision``), eval mode, no gradients.
    ``train=True``: f32 parameters that require gradients, train mode; each
    layer casts them to the compute dtype where it uses them, as the JAX
    package's ``dtype=bf16, param_dtype=f32`` modules do."""
    if name != "streamflow":
        raise KeyError(f"unknown model '{name}'; have ['streamflow']")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_model: no CUDA device; pass device='cpu' "
                           "to build the model on the CPU")
    model = StreamFlow(cfg or StreamFlowConfig(**kwargs))
    if train:
        model = model.train().requires_grad_(True)
    else:
        model = model.to(model.dtype).eval().requires_grad_(False)
    return model.to(device)


__all__ = ["StreamFlow", "create_model"]
