"""Configuration of the port's StreamFlow.

The port's own copy of the JAX package's ``StreamFlowConfig``: the same
fields with the same defaults (the released configuration: Twins_CSC
encoder, SKMotionEncoder6, SKUpdateBlock_TAM_v3 decoder with GMA, T=4, 12
iterations, bf16 compute), so one dict of keyword arguments builds either.

Kernels are chosen by the device of each tensor, in the wrapper that
launches it (``ops/kernels/``): a CUDA tensor launches the kernel, a CPU
tensor takes its plain PyTorch version. No field of this config enters
that choice.

``dw_impl`` picks the layout of the six SK blocks (``layers/sk.py``).
The pair layouts run K2 ``ffn_pair``, the dw stack, K2 ``pw_ffn_pair``,
with the dw stack as: ``'pallas'`` K5 ``dw_chain``; ``'banded_mxu'`` K6
``dw_banded_mxu`` per kxk stage; ``'banded_mxu_t'`` K7 ``dw_banded_mxu_t``
per kxk stage; ``'banded_chain'`` K8 ``sk_chain_banded`` (k_conv (1,)*n +
(k,), else as ``'banded_mxu'``); ``'banded'`` the XLA banded composite
``dw_banded_xla`` in PyTorch, no kernel, as in JAX. Every other value
(``'auto'``, ``'xla'``, the ``xla_cond*`` and ``xla_fenced`` variants)
keeps the edge-fused layout that JAX's ``resolve()`` picks on a TPU
(``xla_cond``: K2 ``ffn_pair_k1``, the depthwise conv alone, K2
``dwres_pw_ffn_pair``).

The other fields that steer the JAX package's TPU kernels are accepted and
ignored: ``corr_impl``, ``corr_store``, ``attn_impl``, ``lga_impl``,
``twins_ffn_fused``, ``lookup_block_q``, ``lookup_unroll``,
``lookup_f2_major``, ``lookup_rows``, ``scan_unroll``, ``dropout`` and
``ffn_gelu`` (the port's gelu is always the exact erf, ``torch.erf``).
``gsa_flash`` is honoured by the Twins encoders and ``remat`` by the
train-mode forward (each refinement step recomputed in the backward).
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

    # TPU kernel choices: dw_impl picks the SK layout, the rest are
    # accepted and ignored (remat aside; see above)
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
