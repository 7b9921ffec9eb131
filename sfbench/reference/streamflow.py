"""Plain StreamFlow (the released configuration: Twins_CSC encoders over
the T frames stacked along the height, SKMotionEncoder6, GMA, the
temporal layer, the SK "gru" and the joint SK flow head, convex
upsampling), written from the reference's equations (littlespray/
StreamFlow, core/models/streamflow.py, core/encoders/twins_csc.py,
core/update.py) in float32 NHWC over a dict of parameters named by the
reference's torch keys.

``forward(P, images, cfg, iters, pr, test_mode)``: images (B, T, H, W, 3)
in [0, 255] -> test mode: flows (B, T-1, H, W, 2); train mode: the flows
of every iteration (iters, B, T-1, H, W, 2), the mask head run on every
iteration. ``pr`` (``ops.Prec``) is the precision of the products.
``sk_blocks`` and ``mlps`` list the model's FFN pair and depthwise work
by shape, for the roofline counts (``counts/kernels.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sfbench.reference.ops import (Prec, attention, avg_pool2, conv,
                                   convex_upsample, coords_grid, corr_lookup,
                                   gelu, layer_norm, lin)

# Twins-SVT-Large stages 1-2 (timm twins_svt_large)
DIMS, HEADS, SR, PATCH, WS, MLP = (128, 256), (4, 8), (8, 4), (4, 2), 7, 4


def _p(P, prefix):
    return lambda name: P[f"{prefix}.{name}"]


def lga(pr, p, x, size, nh):
    """Locally grouped attention over WS x WS windows of the (Ht, W) grid;
    the normed tokens are zero-padded to whole windows before qkv."""
    b, n, c = x.shape
    ht, w = size
    hp, wp = -(-ht // WS) * WS, -(-w // WS) * WS
    xg = F.pad(x.reshape(b, ht, w, c), (0, 0, 0, wp - w, 0, hp - ht))
    qkv = lin(pr, xg, p("qkv.weight"), p("qkv.bias"))
    hd = c // nh
    gh, gw = hp // WS, wp // WS
    t = qkv.reshape(b, gh, WS, gw, WS, 3, nh, hd)
    t = t.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, gh * gw, nh,
                                                  WS * WS, hd)
    out = attention(pr, t[0] * hd ** -0.5, t[1], t[2])
    out = out.reshape(b, gh, gw, nh, WS, WS, hd)
    out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, c)
    out = lin(pr, out, p("proj.weight"), p("proj.bias"))
    return out[:, :ht, :w].reshape(b, n, c)


def gsa(pr, p, x, size, nh, sr):
    """Global attention against sr x sr subsampled keys and values."""
    b, n, c = x.shape
    hd = c // nh
    q = lin(pr, x, p("q.weight"), p("q.bias")).reshape(b, n, nh, hd)
    q = q.transpose(1, 2) * hd ** -0.5
    kv = conv(pr, x.reshape(b, size[0], size[1], c), p("sr.weight"),
              p("sr.bias"), stride=sr)
    kv = layer_norm(kv.reshape(b, -1, c), p("norm.weight"), p("norm.bias"))
    kv = lin(pr, kv, p("kv.weight"), p("kv.bias")).reshape(b, -1, 2, nh, hd)
    out = attention(pr, q, kv[:, :, 0].transpose(1, 2),
                    kv[:, :, 1].transpose(1, 2))
    return lin(pr, out.transpose(1, 2).reshape(b, n, c), p("proj.weight"),
               p("proj.bias"))


def twins_block(pr, p, x, size, nh, sr, windowed):
    y = layer_norm(x, p("norm1.weight"), p("norm1.bias"))
    a = _p_sub(p, "attn")
    x = x + (lga(pr, a, y, size, nh) if windowed
             else gsa(pr, a, y, size, nh, sr))
    y = layer_norm(x, p("norm2.weight"), p("norm2.bias"))
    y = gelu(lin(pr, y, p("mlp.fc1.weight"), p("mlp.fc1.bias")))
    return x + lin(pr, y, p("mlp.fc2.weight"), p("mlp.fc2.bias"))


def _p_sub(p, prefix):
    return lambda name: p(f"{prefix}.{name}")


def twins_csc(pr, P, prefix, x):
    """(B, T, H, W, 3) -> (B, T, H/8, W/8, 256): one token grid of the T
    frames stacked along the height, through both stages."""
    p = _p(P, prefix + ".svt")
    b, t = x.shape[:2]
    for i in range(2):
        h, w, c = x.shape[2:]
        y = conv(pr, x.reshape(b * t, h, w, c),
                 p(f"patch_embeds.{i}.proj.weight"),
                 p(f"patch_embeds.{i}.proj.bias"), stride=PATCH[i])
        hp, wp = y.shape[1], y.shape[2]
        tok = layer_norm(y.reshape(b, t * hp * wp, DIMS[i]),
                         p(f"patch_embeds.{i}.norm.weight"),
                         p(f"patch_embeds.{i}.norm.bias"))
        size = (t * hp, wp)
        tok = twins_block(pr, _p_sub(p, f"blocks.{i}.0"), tok, size,
                          HEADS[i], SR[i], True)
        feat = tok.reshape(b, size[0], size[1], DIMS[i])
        feat = feat + conv(pr, feat, p(f"pos_block.{i}.proj.0.weight"),
                           p(f"pos_block.{i}.proj.0.bias"), padding=1,
                           groups=DIMS[i])
        tok = twins_block(pr, _p_sub(p, f"blocks.{i}.1"),
                          feat.reshape(b, -1, DIMS[i]), size, HEADS[i],
                          SR[i], False)
        x = tok.reshape(b, t, hp, wp, DIMS[i])
    return x


def sk_block(pr, p, x):
    """PCBlock4_Deep_nopool_res: gelu(x + ffn1(x)), then each depthwise
    conv of ``conv_list`` as gelu(x + conv(x)), gelu(x + pw(x)), ffn2."""
    y = gelu(lin(pr, x, p("ffn1.0.weight"), p("ffn1.0.bias")))
    x = gelu(x + lin(pr, y, p("ffn1.2.weight"), p("ffn1.2.bias")))
    i = 0
    while True:
        try:
            wk = p(f"conv_list.{i}.weight")
        except KeyError:
            break
        k = wk.shape[-1]
        x = gelu(x + conv(pr, x, wk, p(f"conv_list.{i}.bias"),
                          padding=k // 2, groups=x.shape[-1]))
        i += 1
    x = gelu(x + lin(pr, x, p("pw.weight"), p("pw.bias")))
    y = gelu(lin(pr, x, p("ffn2.0.weight"), p("ffn2.0.bias")))
    return lin(pr, y, p("ffn2.2.weight"), p("ffn2.2.bias"))


def motion_encoder(pr, p, flow, corr):
    """SKMotionEncoder6 -> 128 motion features (the flow last)."""
    cor = sk_block(pr, _p_sub(p, "convc2"),
                   gelu(sk_block(pr, _p_sub(p, "convc1"), corr)))
    flo = sk_block(pr, _p_sub(p, "convf2"),
                   lin(pr, flow, p("convf1.weight"), p("convf1.bias")))
    out = sk_block(pr, _p_sub(p, "conv"), torch.cat([cor, flo], -1))
    return torch.cat([out, flow], -1)


def gma_qk(pr, P, prefix, inp):
    """GMA's q (pre-scaled) and k, (N, 1, h w, D), from the context."""
    n, h, w, d = inp.shape
    q, k = lin(pr, inp, P[f"{prefix}.to_qk.weight"]).chunk(2, dim=-1)
    return (q.reshape(n, 1, h * w, d) * d ** -0.5, k.reshape(n, 1, h * w, d))


def gma_aggregate(pr, p, qk, mf):
    n, h, w, d = mf.shape
    v = lin(pr, mf, p("to_v.weight")).reshape(n, 1, h * w, d)
    out = attention(pr, qk[0], qk[1], v).reshape(n, h, w, d)
    return mf + p("gamma") * out


def temporal_layer(pr, p, x):
    """A pre-norm block along T (1 head, mlp ratio 2, qkv without bias) on
    every pixel's T tokens. x (B, F, h, w, D)."""
    tok = x.permute(0, 2, 3, 1, 4)
    d = tok.shape[-1]
    y = layer_norm(tok, p("norm1.weight"), p("norm1.bias"))
    q, k, v = lin(pr, y, p("attn.qkv.weight")).chunk(3, dim=-1)
    a = torch.softmax((pr.q(q) * d ** -0.5) @ pr.q(k).transpose(-1, -2), -1)
    y = lin(pr, pr.q(a) @ pr.q(v), p("attn.proj.weight"), p("attn.proj.bias"))
    tok = tok + y
    y = layer_norm(tok, p("norm2.weight"), p("norm2.bias"))
    y = gelu(lin(pr, y, p("mlp.fc1.weight"), p("mlp.fc1.bias")))
    tok = tok + lin(pr, y, p("mlp.fc2.weight"), p("mlp.fc2.bias"))
    return tok.permute(0, 3, 1, 2, 4)


def mask_head(pr, p, net):
    y = torch.relu(conv(pr, net, p("mask.0.weight"), p("mask.0.bias"),
                        padding=1))
    return 0.25 * lin(pr, y, p("mask.2.weight"), p("mask.2.bias"))


def update_block(pr, P, net, inp, corr, flow, qk, compute_mask):
    """SKUpdateBlock_TAM_v3 with GMA: net, inp (B, F, h, w, D), corr
    (B F, h, w, 324), flow (B, F, h, w, 2) -> net, mask or None, delta."""
    p = _p(P, "update_block")
    b, f, h, w, d = net.shape

    def flat(x):
        return x.reshape(b * f, h, w, x.shape[-1])

    mf = motion_encoder(pr, _p_sub(p, "encoder"), flat(flow), corr)
    mf_global = gma_aggregate(pr, _p_sub(p, "aggregator"), qk, mf)
    mf_t = temporal_layer(pr, _p_sub(p, "transformer_block.transformer_block"),
                          mf.reshape(b, f, h, w, d))
    net = sk_block(pr, _p_sub(p, "gru"), torch.cat(
        [flat(net), flat(inp), mf, mf_global, flat(mf_t)], -1))
    joint = net.reshape(b, f, h, w, d).permute(0, 2, 3, 1, 4)
    delta = sk_block(pr, _p_sub(p, "flow_head"), joint.reshape(b, h, w, f * d))
    delta = delta.reshape(b, h, w, f, 2).permute(0, 3, 1, 2, 4)
    mask = mask_head(pr, p, net).reshape(b, f, h, w, -1) if compute_mask \
        else None
    return net.reshape(b, f, h, w, d), mask, delta


def forward(P, images, cfg, iters: int, pr: Prec = Prec(),
            test_mode: bool = True, remat: bool = False):
    """The StreamFlow forward (module docstring). ``cfg``: the
    configuration file's dict. ``remat``: each train-mode iteration
    recomputed in the backward, to bound the reference's memory."""
    b, t = images.shape[:2]
    f = t - 1
    hid = cfg["decoder_dim"] // 2
    x = 2.0 * (images.float() / 255.0) - 1.0
    fmaps = twins_csc(pr, P, "fnet", x)
    cnets = twins_csc(pr, P, "cnet", x[:, :-1])
    h, w, c = fmaps.shape[2:]
    f1 = fmaps[:, :-1].reshape(b * f, h, w, c)
    levels = [fmaps[:, 1:].reshape(b * f, h, w, c)]
    for _ in range(cfg["corr_levels"] - 1):
        levels.append(avg_pool2(levels[-1]))
    net, inp = torch.tanh(cnets[..., :hid]), torch.relu(cnets[..., hid:])
    qk = gma_qk(pr, P, "att", inp.reshape(b * f, h, w, hid))
    coords0 = coords_grid(b * f, h, w, images.device).reshape(b, f, h, w, 2)
    coords1 = coords0
    radius = cfg["corr_radius"]

    def step(net, coords1, compute_mask):
        coords1 = coords1.detach()
        corr = corr_lookup(f1, levels, coords1.reshape(b * f, h, w, 2),
                           radius)
        net, mask, delta = update_block(pr, P, net, inp, corr,
                                        coords1 - coords0, qk, compute_mask)
        return net, mask, coords1 + delta

    def upsample(coords1, mask):
        up = convex_upsample((coords1 - coords0).reshape(b * f, h, w, 2),
                             mask.reshape(b * f, h, w, -1))
        return up.reshape(b, f, *up.shape[1:])

    if not test_mode:
        def train_step(net, coords1):
            net, mask, coords1 = step(net, coords1, True)
            return net, coords1, upsample(coords1, mask)

        flows = []
        for _ in range(iters):
            if remat:
                net, coords1, up = checkpoint(train_step, net, coords1,
                                              use_reentrant=False)
            else:
                net, coords1, up = train_step(net, coords1)
            flows.append(up)
        return torch.stack(flows)
    mask = None
    for i in range(iters):
        net, m, coords1 = step(net, coords1, i == iters - 1)
        mask = m if m is not None else mask
    return upsample(coords1, mask)


def sk_blocks(cfg, b: int, f: int, h: int, w: int):
    """(c_in, c_out, k of the depthwise conv, rows) of every SK block call
    of one refinement iteration over f frame pairs at the 1/8 grid
    (h, w): the motion encoder's four, the gru, the joint flow head over
    the f pairs' channels."""
    d = cfg["decoder_dim"] // 2
    planes = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    k, kp = max(cfg["k_conv"]), max(cfg["pc_updater_conv"])
    rows = b * f * h * w
    return [(planes, 256, k, rows), (256, 192, k, rows), (128, 64, k, rows),
            (256, d - 2, k, rows), (5 * d, d, kp, rows),
            (f * d, 2 * f, k, b * h * w)]


def mlps(cfg, b: int, t: int, hh: int, ww: int):
    """(c, hidden, rows) of every other FFN pair of one forward over t
    frames of hh x ww pixels: two Twins blocks a stage, in the fnet (t
    frames) and the cnet (t - 1)."""
    out = []
    for frames in (t, t - 1):
        h, w = hh, ww
        for c, p in zip(DIMS, PATCH):
            h, w = h // p, w // p
            out += [(c, MLP * c, b * frames * h * w)] * 2
    return out
