"""Configuration of the port's StreamFlow.

The port's own copy of the JAX package's ``StreamFlowConfig``: the same
fields with the same defaults (the released configuration: Twins_CSC
encoder, SKMotionEncoder6, SKUpdateBlock_TAM_v3 decoder with GMA, T=4, 12
iterations, bf16 compute), so one dict of keyword arguments builds either.

Kernels are chosen by the device of each tensor, in the wrapper that
launches it (``ops/kernels/``): a CUDA tensor launches the kernel, a CPU
tensor takes its plain PyTorch version. No field of this config enters
that choice, so the fields that steer the JAX package's TPU kernels are
accepted and ignored: ``corr_impl``, ``corr_store``, ``attn_impl``,
``dw_impl`` (with all of its ``xla_cond*``, ``xla_fenced`` and ``banded*``
variants), ``lga_impl``, ``twins_ffn_fused``, ``lookup_block_q``,
``lookup_unroll``, ``lookup_f2_major``, ``lookup_rows``, ``scan_unroll``,
``remat``, ``dropout`` and ``ffn_gelu`` (the port's gelu is always the
exact erf, ``torch.erf``). ``gsa_flash`` is honoured by the Twins encoders.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class StreamFlowConfig:
    T: int = 4
    encoder: str = "twins_csc"
    update_block: str = "sk_tam_v3"
    motion_encoder: str = "sk6"
    decoder_dim: int = 256
    corr_levels: int = 4
    corr_radius: int = 4
    num_heads: int = 1
    use_gma: bool = True
    k_conv: Sequence[int] = (1, 15)
    pc_updater_conv: Sequence[int] = (1, 7)
    iters: int = 12
    mixed_precision: bool = True
    gsa_flash: bool = False

    # accepted and ignored (TPU kernel choices, training; see above)
    corr_impl: str = "auto"
    corr_store: str = "auto"
    attn_impl: str = "auto"
    dw_impl: str = "auto"
    lookup_block_q: int = 512
    lookup_unroll: int = 2
    lookup_f2_major: str = "w"
    lookup_rows: str = "dynamic"
    lga_impl: str = "auto"
    twins_ffn_fused: Optional[bool] = None
    ffn_gelu: str = "auto"
    dropout: float = 0.0
    scan_unroll: int = 4
    remat: bool = False

    @property
    def hidden_dim(self) -> int:
        return self.decoder_dim // 2

    @property
    def context_dim(self) -> int:
        return self.decoder_dim // 2

    @property
    def ratio(self) -> int:
        return 16 if self.encoder == "umt" else 8

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2
