"""Training of the port's StreamFlow (counterpart of streamflow_tpu.training):
sequence loss, AdamW + linear OneCycle + global-norm clipping, the train
state, the train step and the checkpoints (keep-N train states, npz
parameter files)."""
