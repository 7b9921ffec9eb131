"""streamflow_tpu_torch: the PyTorch + CUDA port of streamflow_tpu.

StreamFlow's inference forward on an NVIDIA H100 (sm_90a), with the TPU
package's Pallas kernels on the main path rewritten as hand-written CUDA
kernels (``csrc/``, wrappers in ``ops/kernels/``). The JAX package stays
the reference; this package imports torch and never jax.
"""

__version__ = "0.1.0"
