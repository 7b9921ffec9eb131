"""Configuration of the port's StreamFlow and of its two-frame baselines
(RAFT, RAFT-GMA, SKFlow: ``RAFTConfig``).

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

``ffn_gelu`` is the gelu of every K2 call (the SK blocks' and the Twins
MLPs'), as JAX's model passes it to its FFN kernels: ``'erf'`` or
``'poly'`` as given, ``'auto'`` the exact ``'erf'`` (JAX resolves
``'poly'`` only on a TPU, and its model turns a leftover ``'auto'`` into
``'erf'``); anything else raises (``ffn_gelu_of``).

The other fields that steer the JAX package's TPU kernels are accepted and
ignored: ``corr_impl``, ``corr_store``, ``attn_impl``, ``lga_impl``,
``twins_ffn_fused``, ``lookup_block_q``, ``lookup_unroll``,
``lookup_f2_major``, ``lookup_rows``, ``scan_unroll`` and ``dropout``.
``gsa_flash`` is honoured by the Twins encoders and ``remat`` by the
train-mode forward (each refinement step recomputed in the backward).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


# the encoders the port runs (every one of the JAX config's): the Twins
# family by name -> (one token grid over the T frames, the blocks'
# temporal hook, a final 3x3x3 conv over (T, H, W)), the RAFT CNN per
# frame ("basic", "resnet18" and "mf_basic" are one module, as in JAX) or
# with temporal hooks ("res18_3d"), and "umt" (the video ViT, at
# decoder_dim=768 only: models/streamflow.py)
TWINS_ENCODERS = {"twins_csc": (True, "none", False),
                  "twins": (False, "none", False),
                  "twins_1dconv": (False, "1dconv", False),
                  "twins_temporal_attention": (False, "attn", False),
                  "twins_3dconv": (False, "none", True)}
CNN_ENCODERS = ("basic", "resnet18", "mf_basic", "res18_3d")


FFN_GELUS = ("erf", "poly")


def ffn_gelu_of(cfg) -> str:
    """The K2 gelu of ``cfg.ffn_gelu``: 'auto' -> 'erf' (JAX's
    models/streamflow.py::_gelu_of off a TPU), 'erf' and 'poly' as
    given."""
    gelu = "erf" if cfg.ffn_gelu == "auto" else cfg.ffn_gelu
    if gelu not in FFN_GELUS:
        raise ValueError(f"ffn_gelu must be 'auto' or one of {FFN_GELUS}, "
                         f"got {cfg.ffn_gelu!r}")
    return gelu


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

    # TPU kernel choices: dw_impl picks the SK layout and ffn_gelu K2's
    # gelu, the rest are accepted and ignored (remat aside; see above)
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


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """The port's copy of the JAX package's ``RAFTConfig``
    (streamflow_tpu/config.py:235-258; reference core/models/raft.py:71-190,
    raftgma.py, sk_decoder.py): the same fields with the same defaults
    (hidden and context 128, 4 levels of radius 4, 12 iterations, bf16).

    ``update_block`` picks the decoder: ``'raft'`` (BasicUpdateBlock),
    ``'gma'`` (GMAUpdateBlock) or ``'sk'`` (SKUpdateBlockAllDecoder, with
    GMA when ``use_gma``). ``encoder`` is the RAFT CNN, the only one JAX's
    RAFT builds.

    ``corr_impl``, ``attn_impl``, ``dw_impl`` and ``dropout`` are accepted
    and ignored, as StreamFlowConfig's TPU fields are: the lookup is K1
    (``FusedCorr``) and GMA K3 in flash form on a CUDA tensor, their plain
    versions on a CPU tensor, and the SK blocks run the default
    (edge-fused) layout, K2 ``ffn_pair_k1``, the depthwise conv, K2
    ``dwres_pw_ffn_pair``. JAX ignores ``dw_impl`` too: its RAFT never
    hands it to the SK blocks (layers/update.py:234-252)."""

    encoder: str = "basic"
    update_block: str = "raft"
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    num_heads: int = 1
    use_gma: bool = False
    k_conv: Sequence[int] = (1, 15)
    pc_updater_conv: Sequence[int] = (1, 7)
    iters: int = 12
    mixed_precision: bool = True
    corr_impl: str = "xla"
    attn_impl: str = "full"
    dw_impl: str = "auto"
    dropout: float = 0.0

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2

    @property
    def uses_gma(self) -> bool:
        """Whether the model computes GMA's attention: always with the
        'gma' block, with the 'sk' block under ``use_gma`` (JAX
        models/raft.py:98-100)."""
        return self.update_block == "gma" or (self.update_block == "sk"
                                              and self.use_gma)
