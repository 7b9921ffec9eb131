"""Host-side utilities of the port (counterpart of streamflow_tpu.utils):
the training logger, phase timers and traces (``profiling``), and the
training curves (``plots``, imported where it is used: matplotlib is
optional)."""

from streamflow_tpu_torch.utils.logger import MetricsLogger, Tee
from streamflow_tpu_torch.utils.profiling import phase_timer, trace_ctx

__all__ = ["MetricsLogger", "Tee", "phase_timer", "trace_ctx"]
