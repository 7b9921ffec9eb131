"""Training of the port's StreamFlow (counterpart of streamflow_tpu.training):
sequence loss, AdamW + linear OneCycle + global-norm clipping, the train
state and the train step."""
