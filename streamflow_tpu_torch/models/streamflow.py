"""StreamFlow (port of streamflow_tpu/models/streamflow.py::StreamFlow and
``_make_encoder``, :55-102, 164-270; reference SKFlow_MF8,
core/models/streamflow.py:30-149).

Every encoder, decoder and ``use_gma`` value of the JAX config: the
Twins family (``twins_csc``, the canonical one; ``twins``,
``twins_1dconv``, ``twins_temporal_attention``, ``twins_3dconv``), the
RAFT CNN per frame (``basic``, ``resnet18`` and ``mf_basic``, one module
as in JAX), ``res18_3d``, and the UMT video ViT (``umt``: 768 channels at
1/16, so the model runs at ratio 16, and only at ``decoder_dim=768``,
the one width at which JAX's model runs: 384-wide hidden and context
states, GMA at d=384, a 1920-wide gru and a 1152-wide joint flow head,
a mask of 9 x 16^2 channels); the decoders
``sk_tam_v3``, ``sk_tam_v1`` (per-frame flow head) and
``sk_tam_v3_noinit`` (live temporal layer). The CNN encoders' fnet uses
instance norm and their cnet BatchNorm, whose statistics follow
``forward``'s ``train`` argument (JAX's ``train``), not
``nn.Module.train()``.

Images (B, T, H, W, 3) in [0, 255] -> flows (B, T-1, H, W, 2), (x, y).
Dtype policy as in the JAX package: encoders, GMA and the update block
compute in bf16 under ``mixed_precision`` (each layer casts its parameters
to that dtype where it uses them); the correlation output is cast to the
model dtype; coordinates, the flow carry and the convex upsampling stay
f32. The refinement ``nn.scan`` is a Python loop and ``stop_gradient`` a
``detach``. Parameters are built in f32, as JAX's ``param_dtype``;
``create_model`` casts an inference model to the compute dtype.

``test_mode`` defaults to False, as JAX's ``__call__``. Test mode (no
autograd) runs the mask head on the last iteration only and
returns the final flows. Train mode (``test_mode=False``) returns the
flows of every iteration, (iters, B, T-1, H, W, 2), with the mask head and
the convex upsampling on every iteration, as JAX's ``compute_mask=None``
path; with ``cfg.remat`` and ``train`` each refinement step is
recomputed in the backward (``torch.utils.checkpoint``, the counterpart
of JAX's ``nn.remat`` under ``cfg.remat and train``), never the encoders,
so no BatchNorm runs twice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from streamflow_tpu_torch.config import (CNN_ENCODERS, TWINS_ENCODERS,
                                         StreamFlowConfig, ffn_gelu_of)
from streamflow_tpu_torch.layers.basic_encoder import (PerFrameBasicEncoder,
                                                       Res18_3D)
from streamflow_tpu_torch.layers.gma import GMAAttention
from streamflow_tpu_torch.layers.twins import TwinsEncoder
from streamflow_tpu_torch.layers.umt import UMT
from streamflow_tpu_torch.layers.update import SKUpdateBlockTAMv3
from streamflow_tpu_torch.ops.coords import coords_grid
from streamflow_tpu_torch.ops.kernels.corr_lookup import FusedCorr
from streamflow_tpu_torch.ops.upsample import convex_upsample

UPDATE_BLOCKS = ("sk_tam_v3", "sk_tam_v1", "sk_tam_v3_noinit")
UMT_DECODER_DIM = 768


def make_encoder(cfg: StreamFlowConfig, norm_fn: str) -> nn.Module:
    """JAX ``_make_encoder``: (B, T, H, W, 3) -> (B, T, H/8, W/8, 256),
    or (B, T, H/16, W/16, 768) for UMT; ``norm_fn`` reaches the CNN
    encoders ('instance' for the fnet, 'batch' for the cnet)."""
    if cfg.encoder in TWINS_ENCODERS:
        return TwinsEncoder(cfg.gsa_flash, *TWINS_ENCODERS[cfg.encoder],
                            gelu=ffn_gelu_of(cfg))
    if cfg.encoder == "res18_3d":
        return Res18_3D(256, norm_fn)
    if cfg.encoder in CNN_ENCODERS:
        return PerFrameBasicEncoder(256, norm_fn)
    if cfg.encoder == "umt":
        return UMT()
    raise ValueError(f"unknown encoder '{cfg.encoder}'")


class StreamFlow(nn.Module):
    def __init__(self, cfg: StreamFlowConfig = StreamFlowConfig()):
        super().__init__()
        if cfg.update_block not in UPDATE_BLOCKS:
            raise ValueError(f"unknown update_block '{cfg.update_block}'")
        if cfg.motion_encoder != "sk6":
            raise ValueError(f"unknown motion_encoder "
                             f"'{cfg.motion_encoder}'")
        if cfg.encoder == "umt" and cfg.decoder_dim != UMT_DECODER_DIM:
            # JAX's model fails here too, reshaping the 384-wide context
            # into context_dim channels (models/streamflow.py:230)
            raise ValueError(
                f"encoder='umt' runs at decoder_dim={UMT_DECODER_DIM} only "
                f"(its 768 channels split into 384-wide hidden and "
                f"context states), got decoder_dim={cfg.decoder_dim}")
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        self.fnet = make_encoder(cfg, "instance")
        self.cnet = make_encoder(cfg, "batch")
        self.att = (GMAAttention(cfg.context_dim, cfg.num_heads,
                                 cfg.context_dim) if cfg.use_gma else None)
        self.update_block = SKUpdateBlockTAMv3(
            cfg.hidden_dim, cfg.T - 1, cfg.corr_planes, cfg.k_conv,
            cfg.pc_updater_conv, cfg.num_heads, cfg.ratio, cfg.dw_impl,
            use_gma=cfg.use_gma,
            joint_flow_head=cfg.update_block != "sk_tam_v1",
            temporal_zero_init=cfg.update_block != "sk_tam_v3_noinit",
            gelu=ffn_gelu_of(cfg))

    def forward(self, images, iters=None, flow_init=None,
                test_mode: bool = False, train: bool = False):
        """Test mode (``test_mode=True``): flows (B, T-1, H, W, 2) f32,
        and with ``flow_init`` (B, T-1, H/8, W/8, 2) also the low-res
        flows. Train mode (the default): the per-iteration flows (iters,
        B, T-1, H, W, 2) f32. ``train`` (JAX's): BatchNorm on batch
        statistics, updating its running statistics, and ``cfg.remat``
        in force; the train step passes it."""
        if test_mode:
            with torch.no_grad():
                return self._run(images, iters, flow_init, True, train)
        return self._run(images, iters, flow_init, False, train)

    def _run(self, images, iters, flow_init, test_mode: bool, train: bool):
        cfg = self.cfg
        iters = cfg.iters if iters is None else iters
        b, t = images.shape[:2]
        f = t - 1
        assert t == cfg.T, f"model is configured for T={cfg.T}, got {t}"

        x = (2.0 * (images.float() / 255.0) - 1.0).to(self.dtype)
        fmaps = self.fnet(x, train)
        cnets = self.cnet(x[:, :-1], train)
        h, w, c = fmaps.shape[2:]
        pyramid = FusedCorr(fmaps[:, :-1].reshape(b * f, h, w, c),
                            fmaps[:, 1:].reshape(b * f, h, w, c),
                            cfg.corr_levels, cfg.corr_radius)
        net, inp = cnets.split(cfg.hidden_dim, dim=-1)
        net, inp = torch.tanh(net), torch.relu(inp)
        attn = (None if self.att is None else
                self.att(inp.reshape(b * f, h, w, cfg.context_dim)))

        coords0 = coords_grid(b * f, h, w, images.device).reshape(
            b, f, h, w, 2)
        coords1 = coords0 if flow_init is None else coords0 + flow_init

        def step(net, coords1, compute_mask):
            coords1 = coords1.detach()
            corr = pyramid.lookup(coords1.reshape(b * f, h, w, 2))
            net, mask, delta = self.update_block(
                net, inp, corr.reshape(b, f, h, w, -1), coords1 - coords0,
                attn, compute_mask=compute_mask)
            return net, mask, coords1 + delta.float()

        def upsample(coords1, mask):
            up = convex_upsample((coords1 - coords0).reshape(b * f, h, w, 2),
                                 mask.reshape(b * f, h, w, -1), cfg.ratio)
            return up.reshape(b, f, *up.shape[1:])

        if not test_mode:
            def train_step(net, coords1):
                net, mask, coords1 = step(net, coords1, True)
                return net, coords1, upsample(coords1, mask)

            flows = []
            for _ in range(iters):
                if cfg.remat and train:
                    net, coords1, up = checkpoint(train_step, net, coords1,
                                                  use_reentrant=False)
                else:
                    net, coords1, up = train_step(net, coords1)
                flows.append(up)
            return torch.stack(flows)

        mask = None
        for i in range(iters):
            net, m, coords1 = step(net, coords1, i == iters - 1)
            if m is not None:
                mask = m
        if mask is None:
            mask = coords1.new_zeros(b, f, h, w, 9 * cfg.ratio ** 2)
        flows = upsample(coords1, mask)
        if flow_init is not None:
            return flows, coords1 - coords0
        return flows
