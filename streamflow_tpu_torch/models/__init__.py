"""Model registry of the port (counterpart of streamflow_tpu.models)."""

from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.models.streamflow import StreamFlow


def create_model(name: str, cfg=None, device=None, **kwargs):
    """Build a model by name ('streamflow', the one the port has so far),
    in its compute dtype, on ``device``, for inference (eval mode,
    parameters without gradients). ``kwargs`` build the config when
    ``cfg`` is None."""
    if name != "streamflow":
        raise KeyError(f"unknown model '{name}'; have ['streamflow']")
    model = StreamFlow(cfg or StreamFlowConfig(**kwargs))
    model = model.eval().requires_grad_(False)
    return model.to(device) if device is not None else model


__all__ = ["StreamFlow", "create_model"]
