"""Host-side utilities of the port (counterpart of streamflow_tpu.utils):
the training logger."""

from streamflow_tpu_torch.utils.logger import MetricsLogger, Tee

__all__ = ["MetricsLogger", "Tee"]
