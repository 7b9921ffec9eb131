"""The checkpoint table of the canonical StreamFlow: flax parameter paths of
the JAX package's model against the reference's torch keys.

The port's own copy of ``build_mapping`` and ``torch_shape_for`` from
``streamflow_tpu/convert/torch_import.py`` (plain Python, no JAX): the port
names its parameters after the torch keys, so this table is what moves
weights (and gradients) between the two packages.

Each rule is (flax path, torch key, kind); kind is the layout rule:

  conv    Conv2d (O, I, kh, kw)  <-> flax kernel (kh, kw, I, O)
  linear  Linear (O, I)          <-> flax kernel (I, O)
  raw     copied as-is (biases, LayerNorm scale/bias, gamma)

A trailing ``?`` marks a leaf that may be absent (a bias-free layer).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def _twins(dst, src, depths=(2, 2)) -> List[Rule]:
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
    return rules


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
                  pc_updater_conv: Sequence[int] = (1, 7)) -> List[Rule]:
    """Rules of the canonical StreamFlow (Twins_CSC + SKMotionEncoder6 +
    SKUpdateBlock_TAM_v3 + GMA); decoder leaves live under the refinement
    scan's ``step/`` prefix on the flax side."""
    rules: List[Rule] = []
    rules += _twins("fnet", "fnet")
    rules += _twins("cnet", "cnet")
    rules += _conv("att/to_qk", "att.to_qk")

    ub_s, ub_d = "update_block", "step/update_block"
    enc = f"{ub_s}.encoder"
    rules += _sk_block(f"{ub_d}/encoder/convc1", f"{enc}.convc1", k_conv)
    rules += _sk_block(f"{ub_d}/encoder/convc2", f"{enc}.convc2", k_conv)
    rules += _conv(f"{ub_d}/encoder/convf1", f"{enc}.convf1")
    rules += _sk_block(f"{ub_d}/encoder/convf2", f"{enc}.convf2", k_conv)
    rules += _sk_block(f"{ub_d}/encoder/conv", f"{enc}.conv", k_conv)
    rules += _conv(f"{ub_d}/aggregator/to_v", f"{ub_s}.aggregator.to_v")
    rules += [(f"{ub_d}/aggregator/gamma", f"{ub_s}.aggregator.gamma", "raw")]
    rules += _temporal(f"{ub_d}/transformer_block",
                       f"{ub_s}.transformer_block")
    rules += _sk_block(f"{ub_d}/gru", f"{ub_s}.gru", pc_updater_conv)
    rules += _sk_block(f"{ub_d}/flow_head", f"{ub_s}.flow_head", k_conv)
    rules += _conv(f"{ub_d}/mask/conv1", f"{ub_s}.mask.0")
    rules += _conv(f"{ub_d}/mask/conv2", f"{ub_s}.mask.2")
    return rules


def torch_shape_for(kind: str, flax_shape) -> tuple:
    """The torch shape of a leaf of flax shape ``flax_shape``."""
    if kind == "conv":
        kh, kw, i, o = flax_shape
        return (o, i, kh, kw)
    if kind == "linear":
        i, o = flax_shape
        return (o, i)
    return tuple(flax_shape)
