"""The checkpoint tables of StreamFlow and of the two-frame baselines:
flax variable paths of the JAX package's models against the reference's
torch keys, for every config the port runs, and the conversion of a
reference ``.pth`` into flax variables (``tools/convert.py``).

The port's own copy of ``build_mapping``, ``_bn``, ``_basic_encoder``,
``build_raft_mapping``, ``convert_raft_checkpoint``,
``convert_streamflow_checkpoint``, ``build_umt_mapping``,
``convert_umt_params``, ``load_torch_checkpoint`` and ``torch_shape_for``
from ``streamflow_tpu/convert/torch_import.py`` (no JAX), widened to the
ablation configs: the port names its parameters
after the torch keys, so these tables are what move weights (and
gradients, and BatchNorm statistics) between the two packages.

Where the JAX package's table has the reference's keys (the Twins stages,
the RAFT CNN of ``_basic_encoder`` with its ``running_mean`` and
``running_var``, the decoder), they are used. Where it has none, the keys
are named after the flax modules: the per-frame Twins hooks
(``svt.blocks.i.j.norm0``, ``.temporal_attn``, ``.temporal_fc``,
``.temporal_conv``), Twins3DConv's final ``temporal_conv``, and Res18_3D
(``layer1.0.norm0``, ``.temporal_attn``, ``.temporal_fc``, ``.spatial``).
The CNN encoders sit under flax's ``enc`` (``_PerFrameBasicEncoder``) at
the reference's ``fnet.`` / ``cnet.`` keys. The UMT encoder's table is the
reference's keys (``build_umt_mapping``) under ``fnet.`` / ``cnet.``, and
the port's one qkv bias (``blocks.i.attn.qkv.bias``) for flax's, which a
reference checkpoint holds as ``q_bias`` and ``v_bias``
(``convert_umt_params`` assembles [q_bias, 0, v_bias]).

Each rule is (flax path, torch key, kind); kind is the layout rule:

  conv    Conv2d (O, I, kh, kw)      <-> flax kernel (kh, kw, I, O)
  conv1d  Conv1d (O, I, k)           <-> flax kernel (k, I, O)
  conv3d  Conv3d (O, I, kt, kh, kw)  <-> flax kernel (kt, kh, kw, I, O)
  conv3d_t1  Conv3d (O, I, 1, kh, kw) <-> flax 2-D kernel (kh, kw, I, O)
  linear  Linear (O, I)              <-> flax kernel (I, O)
  raw     copied as-is (biases, norm scale/bias, gamma, running stats)

A trailing ``?`` marks a leaf that may be absent (a bias-free layer).
``build_mapping`` gives the ``params`` collection's rules,
``build_stats_mapping`` the ``batch_stats`` collection's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from streamflow_tpu_torch.config import (CNN_ENCODERS, TWINS_ENCODERS,
                                         RAFTConfig)

# (dst flax path, src torch key, kind)
Rule = Tuple[str, str, str]


def _conv(dst, src) -> List[Rule]:
    return [(f"{dst}/kernel", f"{src}.weight", "conv"),
            (f"{dst}/bias", f"{src}.bias", "raw?")]


def _linear(dst, src) -> List[Rule]:
    return [(f"{dst}/kernel", f"{src}.weight", "linear"),
            (f"{dst}/bias", f"{src}.bias", "raw?")]


def _ln(dst, src) -> List[Rule]:
    return [(f"{dst}/scale", f"{src}.weight", "raw"),
            (f"{dst}/bias", f"{src}.bias", "raw")]


def _sk_block(dst, src, k_conv) -> List[Rule]:
    rules = _conv(f"{dst}/ffn1_in", f"{src}.ffn1.0")
    rules += _conv(f"{dst}/ffn1_out", f"{src}.ffn1.2")
    for i, k in enumerate(k_conv):
        rules += _conv(f"{dst}/dw{i}_k{k}", f"{src}.conv_list.{i}")
    rules += _conv(f"{dst}/pw", f"{src}.pw")
    rules += _conv(f"{dst}/ffn2_in", f"{src}.ffn2.0")
    rules += _conv(f"{dst}/ffn2_out", f"{src}.ffn2.2")
    return rules


def _twins(dst, src, depths=(2, 2), hook: str = "none",
           conv3d: bool = False) -> List[Rule]:
    """The Twins encoders' stages (the same keys in every variant), the
    per-block ``hook`` ("attn", "1dconv") and Twins3DConv's conv."""
    rules: List[Rule] = []
    for i in range(2):
        rules += _conv(f"{dst}/stages/patch_embed{i}/proj",
                       f"{src}.svt.patch_embeds.{i}.proj")
        rules += _ln(f"{dst}/stages/patch_embed{i}/norm",
                     f"{src}.svt.patch_embeds.{i}.norm")
        rules += _conv(f"{dst}/stages/pos_block{i}/proj",
                       f"{src}.svt.pos_block.{i}.proj.0")
        for j in range(depths[i]):
            bs = f"{src}.svt.blocks.{i}.{j}"
            bd = f"{dst}/stages/stage{i}_block{j}"
            rules += _ln(f"{bd}/norm1", f"{bs}.norm1")
            rules += _ln(f"{bd}/norm2", f"{bs}.norm2")
            rules += _linear(f"{bd}/mlp/fc1", f"{bs}.mlp.fc1")
            rules += _linear(f"{bd}/mlp/fc2", f"{bs}.mlp.fc2")
            rules += _linear(f"{bd}/attn/proj", f"{bs}.attn.proj")
            if j % 2 == 0:  # LocallyGroupedAttn
                rules += _linear(f"{bd}/attn/qkv", f"{bs}.attn.qkv")
            else:  # GlobalSubSampleAttn
                rules += _linear(f"{bd}/attn/q", f"{bs}.attn.q")
                rules += _linear(f"{bd}/attn/kv", f"{bs}.attn.kv")
                rules += _conv(f"{bd}/attn/sr", f"{bs}.attn.sr")
                rules += _ln(f"{bd}/attn/norm", f"{bs}.attn.norm")
            if hook == "attn":
                rules += _ln(f"{bd}/norm0", f"{bs}.norm0")
                rules += _tiny_attention(f"{bd}/temporal_attn",
                                         f"{bs}.temporal_attn")
                rules += _linear(f"{bd}/temporal_fc", f"{bs}.temporal_fc")
            elif hook == "1dconv":
                rules += [(f"{bd}/temporal_conv/kernel",
                           f"{bs}.temporal_conv.weight", "conv1d"),
                          (f"{bd}/temporal_conv/bias",
                           f"{bs}.temporal_conv.bias", "raw")]
    if conv3d:
        rules += [(f"{dst}/temporal_conv/kernel",
                   f"{src}.temporal_conv.weight", "conv3d"),
                  (f"{dst}/temporal_conv/bias", f"{src}.temporal_conv.bias",
                   "raw")]
    return rules


def _tiny_attention(dst, src) -> List[Rule]:
    """layers/temporal.py::TinyAttention's own parameters."""
    return [(f"{dst}/qkv_kernel", f"{src}.qkv.weight", "linear"),
            (f"{dst}/proj_kernel", f"{src}.proj.weight", "linear"),
            (f"{dst}/proj_bias", f"{src}.proj.bias", "raw")]


def _norm(dst, src, kind: str) -> Tuple[List[Rule], List[Rule]]:
    """A ``_Norm`` wrapper's parameters and statistics: BatchNorm's
    (flax's anonymous child 'BatchNorm_0') split into params and stats,
    GroupNorm's ('GroupNorm_0') params; instance and none have none."""
    if kind == "batch":
        return ([(f"{dst}/BatchNorm_0/scale", f"{src}.weight", "raw"),
                 (f"{dst}/BatchNorm_0/bias", f"{src}.bias", "raw")],
                [(f"{dst}/BatchNorm_0/mean", f"{src}.running_mean", "raw"),
                 (f"{dst}/BatchNorm_0/var", f"{src}.running_var", "raw")])
    if kind == "group":
        return ([(f"{dst}/GroupNorm_0/scale", f"{src}.weight", "raw"),
                 (f"{dst}/GroupNorm_0/bias", f"{src}.bias", "raw")], [])
    return [], []


def _residual_block(dst, src, norm_fn: str, down: bool):
    rules, stats = _conv(f"{dst}/conv1", f"{src}.conv1"), []
    rules += _conv(f"{dst}/conv2", f"{src}.conv2")

    def norm(n):
        p, st = _norm(f"{dst}/{n}", f"{src}.{n}", norm_fn)
        rules.extend(p)
        stats.extend(st)
    norm("norm1")
    norm("norm2")
    if down:
        rules += _conv(f"{dst}/downsample", f"{src}.downsample.0")
        norm("norm3")
    return rules, stats


def _basic_encoder(dst, src, norm_fn: str, temporal: bool = False
                   ) -> Tuple[List[Rule], List[Rule]]:
    """The RAFT CNN (reference BasicEncoder, core/extractor.py:121-194) ->
    layers/basic_encoder.py, params and stats; ``temporal``: Res18_3D, a
    hook before each residual block, which then sits under ``spatial``."""
    rules = _conv(f"{dst}/conv1", f"{src}.conv1")
    rules += _conv(f"{dst}/conv2", f"{src}.conv2")
    rules_n, stats = _norm(f"{dst}/norm1", f"{src}.norm1", norm_fn)
    rules += rules_n
    for i, stride in enumerate((1, 2, 2), start=1):
        for j in range(2):
            bs, bd = f"{src}.layer{i}.{j}", f"{dst}/layer{i}_{j}"
            if temporal:
                rules += _ln(f"{bd}/norm0", f"{bs}.norm0")
                rules += _tiny_attention(f"{bd}/temporal_attn",
                                         f"{bs}.temporal_attn")
                rules += _linear(f"{bd}/temporal_fc", f"{bs}.temporal_fc")
                bs, bd = f"{bs}.spatial", f"{bd}/spatial"
            r, st = _residual_block(bd, bs, norm_fn, j == 0 and stride != 1)
            rules += r
            stats += st
    return rules, stats


def build_umt_mapping(depth: int = 4) -> List[Rule]:
    """UMT video ViT encoder (reference core/encoders/umt.py:209-368, the
    4-block ViT-B/16 surgery) -> layers/umt.py::UMT. The reference's
    Attention keeps separate q_bias/v_bias with k pinned to zero
    (umt.py:69-85); the flax qkv bias is assembled from them by
    convert_umt_params."""
    rules: List[Rule] = [
        ("patch_embed/kernel", "patch_embed.proj.weight", "conv3d_t1"),
        ("patch_embed/bias", "patch_embed.proj.bias", "raw?"),
    ]
    for i in range(depth):
        bs, bd = f"blocks.{i}", f"block{i}"
        rules += _ln(f"{bd}/norm1", f"{bs}.norm1")
        rules += _ln(f"{bd}/norm2", f"{bs}.norm2")
        rules += [(f"{bd}/qkv/kernel", f"{bs}.attn.qkv.weight", "linear")]
        rules += _linear(f"{bd}/proj", f"{bs}.attn.proj")
        rules += _linear(f"{bd}/mlp/fc1", f"{bs}.mlp.fc1")
        rules += _linear(f"{bd}/mlp/fc2", f"{bs}.mlp.fc2")
    return rules


def convert_umt_params(state_dict: Dict[str, np.ndarray], depth: int = 4,
                       prefix: str = "", strict: bool = True) -> dict:
    """Torch UMT/VideoMAE state-dict -> flax params tree for layers/umt.py.
    ``prefix`` addresses a sub-module (e.g. 'fnet.' inside a full model)."""
    sd = _strip_wrappers(state_dict)
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    tree: dict = {}
    _apply_table(tree, sd, build_umt_mapping(depth), strict)
    # qkv bias = [q_bias, zeros, v_bias] (k bias is a softmax no-op, pinned
    # to zero by the reference)
    for i in range(depth):
        qb = sd.get(f"blocks.{i}.attn.q_bias")
        vb = sd.get(f"blocks.{i}.attn.v_bias")
        if qb is None or vb is None:
            if strict:
                raise KeyError(f"checkpoint missing q/v bias for block {i}")
            continue
        qb = np.asarray(qb)
        _set(tree, f"block{i}/qkv/bias",
             np.concatenate([qb, np.zeros_like(qb), np.asarray(vb)]))
    return {"params": tree}


def _umt(dst, src, depth: int = 4) -> List[Rule]:
    """The UMT table under a model's fnet / cnet, with the port's one qkv
    bias for flax's."""
    rules = [(f"{dst}/{d}", f"{src}.{s}", k)
             for d, s, k in build_umt_mapping(depth)]
    return rules + [(f"{dst}/block{i}/qkv/bias",
                     f"{src}.blocks.{i}.attn.qkv.bias", "raw")
                    for i in range(depth)]


def _encoder(dst, src, encoder: str, norm_fn: str
             ) -> Tuple[List[Rule], List[Rule]]:
    if encoder == "umt":
        return _umt(dst, src), []
    if encoder in TWINS_ENCODERS:
        _, hook, conv3d = TWINS_ENCODERS[encoder]
        return _twins(dst, src, hook=hook, conv3d=conv3d), []
    if encoder == "res18_3d":
        return _basic_encoder(dst, src, norm_fn, temporal=True)
    if encoder in CNN_ENCODERS:
        return _basic_encoder(f"{dst}/enc", src, norm_fn)
    raise NotImplementedError(f"no table for encoder '{encoder}'")


def _temporal(dst, src) -> List[Rule]:
    blk = f"{src}.transformer_block"
    return [
        (f"{dst}/block/norm1/scale", f"{blk}.norm1.weight", "raw"),
        (f"{dst}/block/norm1/bias", f"{blk}.norm1.bias", "raw"),
        (f"{dst}/block/norm2/scale", f"{blk}.norm2.weight", "raw"),
        (f"{dst}/block/norm2/bias", f"{blk}.norm2.bias", "raw"),
        (f"{dst}/block/attn/qkv_kernel", f"{blk}.attn.qkv.weight", "linear"),
        (f"{dst}/block/attn/proj_kernel", f"{blk}.attn.proj.weight", "linear"),
        (f"{dst}/block/attn/proj_bias", f"{blk}.attn.proj.bias", "raw"),
        (f"{dst}/block/mlp/fc1_kernel", f"{blk}.mlp.fc1.weight", "linear"),
        (f"{dst}/block/mlp/fc1_bias", f"{blk}.mlp.fc1.bias", "raw"),
        (f"{dst}/block/mlp/fc2_kernel", f"{blk}.mlp.fc2.weight", "linear"),
        (f"{dst}/block/mlp/fc2_bias", f"{blk}.mlp.fc2.bias", "raw"),
    ]


def build_mapping(k_conv: Sequence[int] = (1, 15),
                  pc_updater_conv: Sequence[int] = (1, 7),
                  encoder: str = "twins_csc", use_gma: bool = True
                  ) -> List[Rule]:
    """Rules of the ``params`` collection of StreamFlow with ``encoder``
    (fnet instance-normed, cnet batch-normed where the encoder is a CNN)
    + SKMotionEncoder6 + the SKUpdateBlock_TAM family (v3, v1 and
    v3_noinit have the same leaves) [+ GMA]; decoder leaves live under the
    refinement scan's ``step/`` prefix on the flax side. The default is
    the canonical config."""
    rules: List[Rule] = []
    rules += _encoder("fnet", "fnet", encoder, "instance")[0]
    rules += _encoder("cnet", "cnet", encoder, "batch")[0]
    if use_gma:
        rules += _conv("att/to_qk", "att.to_qk")

    ub_s, ub_d = "update_block", "step/update_block"
    enc = f"{ub_s}.encoder"
    rules += _sk_block(f"{ub_d}/encoder/convc1", f"{enc}.convc1", k_conv)
    rules += _sk_block(f"{ub_d}/encoder/convc2", f"{enc}.convc2", k_conv)
    rules += _conv(f"{ub_d}/encoder/convf1", f"{enc}.convf1")
    rules += _sk_block(f"{ub_d}/encoder/convf2", f"{enc}.convf2", k_conv)
    rules += _sk_block(f"{ub_d}/encoder/conv", f"{enc}.conv", k_conv)
    if use_gma:
        rules += _conv(f"{ub_d}/aggregator/to_v", f"{ub_s}.aggregator.to_v")
        rules += [(f"{ub_d}/aggregator/gamma", f"{ub_s}.aggregator.gamma",
                   "raw")]
    rules += _temporal(f"{ub_d}/transformer_block",
                       f"{ub_s}.transformer_block")
    rules += _sk_block(f"{ub_d}/gru", f"{ub_s}.gru", pc_updater_conv)
    rules += _sk_block(f"{ub_d}/flow_head", f"{ub_s}.flow_head", k_conv)
    rules += _conv(f"{ub_d}/mask/conv1", f"{ub_s}.mask.0")
    rules += _conv(f"{ub_d}/mask/conv2", f"{ub_s}.mask.2")
    return rules


def build_stats_mapping(encoder: str = "twins_csc") -> List[Rule]:
    """Rules of the ``batch_stats`` collection (the cnet's BatchNorm
    running statistics of the CNN encoders; none for the Twins family)."""
    return (_encoder("fnet", "fnet", encoder, "instance")[1]
            + _encoder("cnet", "cnet", encoder, "batch")[1])


def table_kwargs(cfg) -> dict:
    """``build_mapping``'s arguments for a StreamFlowConfig (either
    package's), or the canonical ones for None."""
    if cfg is None:
        return {}
    return dict(k_conv=tuple(cfg.k_conv),
                pc_updater_conv=tuple(cfg.pc_updater_conv),
                encoder=cfg.encoder, use_gma=cfg.use_gma)


def build_raft_mapping(update_block: str, use_gma: bool,
                       k_conv: Sequence[int] = (1, 15),
                       pc_updater_conv: Sequence[int] = (1, 7),
                       ) -> Tuple[List[Rule], List[Rule]]:
    """(params rules, batch_stats rules) of the two-frame baselines
    (reference core/models/raft.py:71-190, raftgma.py,
    sk_decoder.py:79-209): the RAFT CNN fnet (instance norm) and cnet
    (BatchNorm), then BasicUpdateBlock / GMAUpdateBlock /
    SKUpdateBlock6_Deep_nopoolres_AllDecoder (core/update.py:1932-1953,
    2245-2268, 410-448) under the refinement scan's ``step/`` prefix,
    GMA's tensors under ``use_gma`` (``RAFTConfig.uses_gma``)."""
    rules, stats = _basic_encoder("fnet", "fnet", "instance")
    r2, s2 = _basic_encoder("cnet", "cnet", "batch")
    rules += r2
    stats += s2

    ub_s, ub_d = "update_block", "step/update_block"
    if update_block == "sk":
        enc = f"{ub_s}.encoder"
        rules += _sk_block(f"{ub_d}/encoder/convc1", f"{enc}.convc1", k_conv)
        rules += _sk_block(f"{ub_d}/encoder/convc2", f"{enc}.convc2", k_conv)
        rules += _conv(f"{ub_d}/encoder/convf1", f"{enc}.convf1")
        rules += _sk_block(f"{ub_d}/encoder/convf2", f"{enc}.convf2", k_conv)
        rules += _sk_block(f"{ub_d}/encoder/conv", f"{enc}.conv", k_conv)
        rules += _sk_block(f"{ub_d}/gru", f"{ub_s}.gru", pc_updater_conv)
        rules += _sk_block(f"{ub_d}/flow_head", f"{ub_s}.flow_head", k_conv)
    else:
        for c in ("convc1", "convc2", "convf1", "convf2", "conv"):
            rules += _conv(f"{ub_d}/encoder/{c}", f"{ub_s}.encoder.{c}")
        for tn, jn in (("1", "h"), ("2", "v")):
            for g in ("convz", "convr", "convq"):
                rules += _conv(f"{ub_d}/gru/{g}_{jn}", f"{ub_s}.gru.{g}{tn}")
        rules += _conv(f"{ub_d}/flow_head/conv1", f"{ub_s}.flow_head.conv1")
        rules += _conv(f"{ub_d}/flow_head/conv2", f"{ub_s}.flow_head.conv2")
    rules += _conv(f"{ub_d}/mask/conv1", f"{ub_s}.mask.0")
    rules += _conv(f"{ub_d}/mask/conv2", f"{ub_s}.mask.2")
    if use_gma:
        rules += _conv("att/to_qk", "att.to_qk")
        rules += _conv(f"{ub_d}/aggregator/to_v", f"{ub_s}.aggregator.to_v")
        rules += [(f"{ub_d}/aggregator/gamma", f"{ub_s}.aggregator.gamma",
                   "raw")]
    return rules, stats


def tables(cfg) -> Tuple[List[Rule], List[Rule]]:
    """(params rules, batch_stats rules) of a config of either package:
    a RAFTConfig's, a StreamFlowConfig's, or the canonical StreamFlow's
    for None."""
    if cfg is not None and cfg.update_block in ("raft", "gma", "sk"):
        return build_raft_mapping(cfg.update_block,
                                  RAFTConfig.uses_gma.fget(cfg),
                                  tuple(cfg.k_conv),
                                  tuple(cfg.pc_updater_conv))
    kw = table_kwargs(cfg)
    return build_mapping(**kw), build_stats_mapping(
        kw.get("encoder", "twins_csc"))


# ---------------------------------------------------------------- .pth
def apply_rule(kind: str, value: np.ndarray) -> np.ndarray:
    """A torch tensor in the flax layout of its rule's kind."""
    value = np.asarray(value)
    kind = kind.rstrip("?")
    if kind == "conv3d_t1":
        # Conv3d with tubelet size 1 (a time extent of 1) -> 2-D kernel
        return np.transpose(value[:, :, 0], TO_FLAX["conv"])
    return np.transpose(value, TO_FLAX[kind]) if kind in TO_FLAX else value


def from_flax_layout(kind: str, value: np.ndarray) -> np.ndarray:
    """A flax leaf in the torch layout of its rule's kind (the inverse of
    ``apply_rule``)."""
    kind = kind.rstrip("?")
    if kind == "conv3d_t1":
        return np.transpose(value, np.argsort(TO_FLAX["conv"]))[:, :, None]
    if kind not in TO_FLAX:
        return value
    return np.transpose(value, np.argsort(TO_FLAX[kind]))


def _set(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


def _strip_wrappers(state_dict: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
    """Unwrap the reference checkpoint format: an optional {'model': ...}
    key and DataParallel 'module.' prefixes (train_mf.py:207-212,
    demo.py:388)."""
    if "model" in state_dict and isinstance(state_dict["model"], dict):
        state_dict = state_dict["model"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def _apply_table(tree: dict, sd: Dict[str, np.ndarray],
                 table: Sequence[Rule], strict: bool) -> None:
    """One table into ``tree``; a rule whose kind ends in '?' may lack its
    source key, and ``strict=False`` skips any missing key."""
    for dst, src, kind in table:
        if src not in sd:
            if kind.endswith("?") or not strict:
                continue
            raise KeyError(f"checkpoint missing '{src}' (for {dst})")
        _set(tree, dst, apply_rule(kind, sd[src]))


def convert_streamflow_checkpoint(state_dict: Dict[str, np.ndarray],
                                  k_conv: Sequence[int] = (1, 15),
                                  pc_updater_conv: Sequence[int] = (1, 7),
                                  strict: bool = True) -> dict:
    """A flat torch state_dict of the canonical StreamFlow -> {'params':
    flax tree}. Takes raw or {'model': ...}-wrapped dicts and strips
    'module.' prefixes."""
    tree: dict = {}
    _apply_table(tree, _strip_wrappers(state_dict),
                 build_mapping(k_conv, pc_updater_conv), strict)
    return {"params": tree}


def convert_raft_checkpoint(state_dict: Dict[str, np.ndarray],
                            update_block: str = "raft",
                            strict: bool = True) -> dict:
    """A flat torch state_dict of a two-frame baseline (update_block
    'raft' | 'gma' | 'sk'; GMA with 'gma' and 'sk', as JAX's converter) ->
    {'params', 'batch_stats'} flax trees. Takes raw or
    {'model': ...}-wrapped dicts and strips 'module.' prefixes."""
    sd = _strip_wrappers(state_dict)
    rules, stats = build_raft_mapping(update_block, update_block != "raft")
    out = {"params": {}, "batch_stats": {}}
    _apply_table(out["params"], sd, rules, strict)
    _apply_table(out["batch_stats"], sd, stats, strict)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A .pth file -> {key: numpy array}, unwrapping its 'model' key."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if (isinstance(ckpt, dict) and "model" in ckpt
            and isinstance(ckpt["model"], dict)):
        ckpt = ckpt["model"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in ckpt.items()}


# flax layout (axes) of a torch tensor of each kind; the inverse is argsort
TO_FLAX = {"conv": (2, 3, 1, 0), "conv1d": (2, 1, 0),
           "conv3d": (2, 3, 4, 1, 0), "linear": (1, 0)}


def torch_shape_for(kind: str, flax_shape) -> tuple:
    """The torch shape of a leaf of flax shape ``flax_shape``."""
    if kind == "conv3d_t1":
        kh, kw, i, o = flax_shape
        return (o, i, 1, kh, kw)
    if kind not in TO_FLAX:
        return tuple(flax_shape)
    to_torch = sorted(range(len(flax_shape)),
                      key=TO_FLAX[kind].__getitem__)
    return tuple(flax_shape[a] for a in to_torch)
