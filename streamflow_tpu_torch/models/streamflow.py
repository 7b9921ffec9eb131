"""StreamFlow in test mode (port of streamflow_tpu/models/streamflow.py::
StreamFlow; reference SKFlow_MF8, core/models/streamflow.py:30-149).

Images (B, T, H, W, 3) in [0, 255] -> flows (B, T-1, H, W, 2), (x, y).
Dtype policy as in the JAX package: encoders, GMA and the update block
compute in bf16 under ``mixed_precision`` (the parameters are held in that
dtype); the correlation output is cast to the model dtype; coordinates,
the flow carry and the convex upsampling stay f32. The refinement
``nn.scan`` is a Python loop and ``stop_gradient`` a ``detach``; the mask
head runs on the last iteration only.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.layers.gma import GMAAttention
from streamflow_tpu_torch.layers.twins import TwinsCSC
from streamflow_tpu_torch.layers.update import SKUpdateBlockTAMv3
from streamflow_tpu_torch.ops.coords import coords_grid
from streamflow_tpu_torch.ops.kernels.corr_lookup import FusedCorr
from streamflow_tpu_torch.ops.upsample import convex_upsample

_CANONICAL = dict(encoder="twins_csc", update_block="sk_tam_v3",
                  motion_encoder="sk6", use_gma=True)


class StreamFlow(nn.Module):
    def __init__(self, cfg: StreamFlowConfig = StreamFlowConfig()):
        super().__init__()
        for field, want in _CANONICAL.items():
            if getattr(cfg, field) != want:
                raise NotImplementedError(
                    f"the port runs the canonical StreamFlow only: "
                    f"{field}={getattr(cfg, field)!r} (want {want!r})")
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        self.fnet = TwinsCSC(cfg.gsa_flash)
        self.cnet = TwinsCSC(cfg.gsa_flash)
        self.att = GMAAttention(cfg.context_dim, cfg.num_heads,
                                cfg.context_dim)
        self.update_block = SKUpdateBlockTAMv3(
            cfg.hidden_dim, cfg.T - 1, cfg.corr_planes, cfg.k_conv,
            cfg.pc_updater_conv, cfg.num_heads, cfg.ratio)
        self.to(self.dtype)

    @torch.no_grad()
    def forward(self, images, iters=None, flow_init=None):
        """Test mode. Returns flows (B, T-1, H, W, 2) f32, and with
        ``flow_init`` (B, T-1, H/8, W/8, 2) also the low-res flows."""
        cfg = self.cfg
        iters = cfg.iters if iters is None else iters
        b, t = images.shape[:2]
        f = t - 1
        assert t == cfg.T, f"model is configured for T={cfg.T}, got {t}"

        x = (2.0 * (images.float() / 255.0) - 1.0).to(self.dtype)
        fmaps = self.fnet(x)
        cnets = self.cnet(x[:, :-1])
        h, w, c = fmaps.shape[2:]
        pyramid = FusedCorr(fmaps[:, :-1].reshape(b * f, h, w, c),
                            fmaps[:, 1:].reshape(b * f, h, w, c),
                            cfg.corr_levels, cfg.corr_radius)
        net, inp = cnets.split(cfg.hidden_dim, dim=-1)
        net, inp = torch.tanh(net), torch.relu(inp)
        attn = self.att(inp.reshape(b * f, h, w, cfg.context_dim))

        coords0 = coords_grid(b * f, h, w, images.device).reshape(
            b, f, h, w, 2)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        mask = None
        for i in range(iters):
            coords1 = coords1.detach()
            corr = pyramid.lookup(coords1.reshape(b * f, h, w, 2))
            net, m, delta = self.update_block(
                net, inp, corr.reshape(b, f, h, w, -1), coords1 - coords0,
                attn, compute_mask=i == iters - 1)
            if m is not None:
                mask = m
            coords1 = coords1 + delta.float()

        lowres = coords1 - coords0
        if mask is None:
            mask = lowres.new_zeros(b, f, h, w, 9 * cfg.ratio ** 2)
        up = convex_upsample(lowres.reshape(b * f, h, w, 2),
                             mask.reshape(b * f, h, w, -1), cfg.ratio)
        flows = up.reshape(b, f, *up.shape[1:])
        if flow_init is not None:
            return flows, lowres
        return flows
