"""idle_share.train: the share of the traced slice in which no kernel or
copy runs on the card (1 - the union of the device activities' spans
over the slice's host seconds), in %. The profiler's own cost is in the
slice. Layer: device. Moves train_clips_per_s."""


def read(view):
    if view.window_s <= 0 or not view.trace.device:
        return None
    return 100.0 * (1.0 - view.trace.busy_s() / view.window_s)
