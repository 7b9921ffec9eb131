"""Model registry of the port (counterpart of streamflow_tpu.models): the
multi-frame 'streamflow' and the two-frame baselines 'raft', 'raft_gma'
and 'skflow', with the JAX registry's decoders (models/__init__.py:7-17)."""

import torch

from streamflow_tpu_torch.config import RAFTConfig, StreamFlowConfig
from streamflow_tpu_torch.models.raft import RAFT
from streamflow_tpu_torch.models.streamflow import StreamFlow

_REGISTRY = {
    "streamflow": lambda cfg, **kw: StreamFlow(cfg or StreamFlowConfig(**kw)),
    "raft": lambda cfg, **kw: RAFT(cfg or RAFTConfig(update_block="raft",
                                                     **kw)),
    "raft_gma": lambda cfg, **kw: RAFT(cfg or RAFTConfig(update_block="gma",
                                                         **kw)),
    "skflow": lambda cfg, **kw: RAFT(cfg or RAFTConfig(
        update_block="sk", use_gma=True, **kw)),
}


def create_model(name: str, cfg=None, device="cuda", train: bool = False,
                 **kwargs):
    """Build a model by name on ``device``: the card unless the caller asks
    for ``device="cpu"``; a CUDA device without a card raises. ``kwargs``
    build the config when ``cfg`` is None: for 'streamflow' every
    ``encoder``, ``update_block`` and ``use_gma`` of the JAX config
    (``encoder="umt"`` at ``decoder_dim=768`` only, as JAX's model runs;
    another ``decoder_dim`` raises ValueError).

    ``train=False``: for inference, parameters in the compute dtype
    (bf16 under ``mixed_precision``; BatchNorm's and GroupNorm's stay f32,
    as flax's), eval mode, no gradients.
    ``train=True``: f32 parameters that require gradients, train mode; each
    layer casts them to the compute dtype where it uses them, as the JAX
    package's ``dtype=bf16, param_dtype=f32`` modules do."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(_REGISTRY)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_model: no CUDA device; pass device='cpu' "
                           "to build the model on the CPU")
    model = _REGISTRY[name](cfg, **kwargs)
    if train:
        model = model.train().requires_grad_(True)
    else:
        model = model.to(model.dtype).eval().requires_grad_(False)
    return model.to(device)


__all__ = ["StreamFlow", "RAFT", "create_model"]
