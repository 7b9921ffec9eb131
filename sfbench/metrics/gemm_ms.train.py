"""gemm_ms.train: device ms a step of the kernels that the frozen
KERNEL_GROUPS (``counts/profile.py``) puts in ``gemm`` (cuBLAS and
CUTLASS products: most of them the K1/K2 composite backwards). Layer:
kernels (the step's GEMMs). Moves train_clips_per_s."""

from sfbench.counts.profile import kernel_group


def read(view):
    if not view.units:
        return None
    s = view.trace.device_s(lambda n: kernel_group(n) == "gemm")
    return 1e3 * s / view.units if s > 0 else None
