"""The port's data layer (its own copy of streamflow_tpu/data): file codecs,
flow visualisation, augmentation, the multi-frame and two-frame datasets
(``mf_datasets``, ``datasets``) and the batch loader, all NumPy on the
host, and the loader's prefetch to the card
(``loader.prefetch_to_device``)."""

from streamflow_tpu_torch.data import frame_utils
from streamflow_tpu_torch.data.flow_viz import flow_to_image

__all__ = ["frame_utils", "flow_to_image"]
