"""The port's data layer (its own copy of streamflow_tpu/data): file codecs,
flow visualisation, augmentation, the multi-frame datasets and the batch
loader, all NumPy on the host, and the loader's prefetch to the card
(``loader.prefetch_to_device``). The two-frame datasets come with the
two-frame models."""

from streamflow_tpu_torch.data import frame_utils
from streamflow_tpu_torch.data.flow_viz import flow_to_image

__all__ = ["frame_utils", "flow_to_image"]
