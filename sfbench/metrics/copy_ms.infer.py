"""copy_ms.infer: device ms a request of host <-> device copies (the
profiler's Memcpy activities: the clip copied in, the flows copied out).
Layer: serving (evaluation.GraphedForward). Moves flows_per_s."""


def read(view):
    if not view.units:
        return None
    s = view.trace.device_s(lambda n: n.startswith("Memcpy"))
    return 1e3 * s / view.units if s > 0 else None
