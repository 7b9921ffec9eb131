"""mfu.train: the share of the bf16 peak (989 TFLOP/s, every product
counted against it) that one training step's model FLOPs make (the
plain reference's forward and backward, without rematerialisation,
``counts/flops.py``): FLOPs / (host seconds a step in the untraced rest
of the traced run's window x peak), in %. Layer: training step. Moves
train_clips_per_s."""

from sfbench.counts.profile import PEAK_BF16


def read(view):
    if not view.units:
        return None
    return 100.0 * view.model_flops / (view.trace.wall_per_unit() * PEAK_BF16)
