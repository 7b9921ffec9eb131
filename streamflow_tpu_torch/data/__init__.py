"""The port's data layer (its own copy of streamflow_tpu/data): file codecs,
flow visualisation, augmentation and the multi-frame datasets, all NumPy on
the host. The two-frame datasets and the loader come with the rest of
training."""

from streamflow_tpu_torch.data import frame_utils
from streamflow_tpu_torch.data.flow_viz import flow_to_image

__all__ = ["frame_utils", "flow_to_image"]
