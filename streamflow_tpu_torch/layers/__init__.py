"""Layers of the port (counterparts of streamflow_tpu.layers)."""
from streamflow_tpu_torch.layers.gma import (
    GMAAggregate,
    GMAAttention,
    SpatioTemporalAggregate,
    SpatioTemporalAggregate2,
    TemporalAggregate,
    TemporalAttentionMap,
    TMMAggregate,
)

__all__ = [
    "GMAAttention",
    "GMAAggregate",
    "TemporalAttentionMap",
    "TemporalAggregate",
    "SpatioTemporalAggregate",
    "SpatioTemporalAggregate2",
    "TMMAggregate",
]
