"""The port's ablation encoders against the JAX package's, module by module:
every encoder name of the JAX config but UMT (the per-frame Twins family,
the RAFT CNN per frame under its three names, Res18_3D), the RAFT CNN in
each of its four norms, BatchNorm in train mode (outputs and the updated
running statistics, then eval mode on them), the BatchNorm layer alone
with its gradients (f32) and under bf16 inputs, AttnBasicEncoder, the
4-head TinyAttention of Res18_3D's hooks and the live-init temporal
layer.

CPU, f32, seeded numpy inputs (a (1, 4, 64, 96, 3) clip in [-1, 1]);
every parameter random from a seed on both sides
(``_torch_parity.randomize_params``: the zero- and dirac-init hooks are
live, so a missing hook shows), running means 0.1 r and variances
0.5 + u, moved into the port through the bridge's tables
(``streamflow_tpu_torch/convert.py``). The encoders' outputs are O(1)-O(10):
tolerance 1e-4 abs and rel (f32 in another summation order, as
tests/test_torch_layers.py); BatchNorm's running statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_params
from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.layers import basic_encoder as jbe
from streamflow_tpu.layers.temporal import TemporalLayer as JTemporalLayer
from streamflow_tpu.layers.temporal import TinyAttention as JTinyAttention
from streamflow_tpu.models.streamflow import _make_encoder
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.convert import (_basic_encoder, build_mapping,
                                          build_stats_mapping)
from streamflow_tpu_torch.layers import basic_encoder as pbe
from streamflow_tpu_torch.layers.common import BatchNorm
from streamflow_tpu_torch.layers.temporal import TemporalLayer, TinyAttention
from streamflow_tpu_torch.models.streamflow import make_encoder
from streamflow_tpu_torch.params import _flatten, _from_flat

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
STATS_TOL = dict(atol=1e-5, rtol=1e-5)
CNN = ("basic", "resnet18", "mf_basic", "res18_3d")
ENCODERS = ["twins_csc", "twins", "twins_1dconv", "twins_temporal_attention",
            "twins_3dconv", *CNN]


def _clip(seed=0, n=(1, 4), h=64, w=96):
    return np.random.default_rng(seed).uniform(
        -1, 1, (*n, h, w, 3)).astype(np.float32)


def _stats(tree, seed):
    """Running statistics: means 0.1 r, variances 0.5 + u."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if hasattr(v, "items") else (
            (0.5 + rng.random(np.shape(v))) if k == "var"
            else 0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in node.items()}
    return walk(tree)


def _variables(module, x, seed, **kw):
    """Random params (and batch_stats) of a flax module for input x,
    from its shapes (no init compile)."""
    shapes = jax.eval_shape(lambda k, a: module.init(k, a, **kw),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    out = {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        randomize_params(zeros["params"], seed))}
    if "batch_stats" in zeros:
        out["batch_stats"] = _stats(zeros["batch_stats"], seed + 1)
    return out


def _port_sd(variables, rules, stats, dst_pre, src_pre):
    """The port tensors of flax ``variables`` (a module's own tree, placed
    under the table's ``dst_pre``) by the table's rules under it, keyed
    without ``src_pre``. Raises on a leaf no rule takes."""
    sd = {}
    for coll, table in (("params", rules), ("batch_stats", stats)):
        if coll not in variables:
            continue
        flat = {dst_pre + k: a for k, a in _flatten(variables[coll]).items()}
        table = [r for r in table if r[0].startswith(dst_pre)]
        sd.update({k[len(src_pre):]: v for k, v in
                   _from_flat(flat, table, coll).items()})
    return sd


def _load_encoder(encoder, norm, which, variables):
    """The port's encoder of the model slot ``which`` (fnet or cnet) with
    JAX's variables, through the model's tables."""
    module = make_encoder(StreamFlowConfig(encoder=encoder,
                                           mixed_precision=False), norm)
    module.load_state_dict(_port_sd(
        variables, build_mapping(encoder=encoder),
        build_stats_mapping(encoder), f"{which}/", f"{which}."))
    return module


def _apply(module, variables, *args, **kw):
    return np.asarray(jax.jit(lambda v, *a: module.apply(v, *a, **kw))(
        variables, *map(jnp.asarray, args)))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_encoder_matches_jax(encoder):
    """Each encoder in eval mode against JAX's ``_make_encoder``: the fnet
    (instance norm for the CNNs) and, for the CNN encoders, the cnet
    (BatchNorm on its running statistics) too."""
    x = _clip()
    slots = (("fnet", "instance"), ("cnet", "batch"))
    for which, norm in slots[:1 + (encoder in CNN)]:
        jenc = _make_encoder(JaxConfig(encoder=encoder,
                                       mixed_precision=False),
                             None, norm, which)
        v = _variables(jenc, x, seed=3)
        want = _apply(jenc, v, x)
        got = _load_encoder(encoder, norm, which, v)(torch.from_numpy(x))
        assert got.shape == (1, 4, 8, 12, 256) == want.shape
        _close(got, want)


@pytest.mark.parametrize("norm", ["batch", "instance", "group", "none"])
def test_basic_encoder_norms_match_jax(norm):
    """BasicEncoder (output 128, two images) in each kind of ``_Norm``:
    flax's BatchNorm (eval mode), the affine-free InstanceNorm, flax's
    GroupNorm (max(1, C/8) groups, eps 1e-6) and none."""
    x = _clip(1, n=(2,))
    jenc = jbe.BasicEncoder(128, norm)
    v = _variables(jenc, x, seed=5)
    rules, stats = _basic_encoder("e", "e", norm)
    tenc = pbe.BasicEncoder(128, norm)
    tenc.load_state_dict(_port_sd(v, rules, stats, "e/", "e."))
    _close(tenc(torch.from_numpy(x)), _apply(jenc, v, x))


@pytest.mark.parametrize("encoder", ["basic", "res18_3d"])
def test_batchnorm_train_mode_matches_jax(encoder):
    """The cnet in train mode against JAX's apply with a mutable
    ``batch_stats``: the outputs (batch statistics, f32) and the updated
    running statistics (flax: momentum 0.9, the biased batch variance);
    then eval mode on the updated statistics."""
    x = _clip(2)
    cfg = JaxConfig(encoder=encoder, mixed_precision=False)
    jenc = _make_encoder(cfg, None, "batch", "cnet", True)
    v = _variables(jenc, x, seed=7)
    want, upd = jax.jit(lambda v, a: jenc.apply(
        v, a, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tenc = _load_encoder(encoder, "batch", "cnet", v)
    before = {k: t.clone() for k, t in tenc.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
    _close(tenc(torch.from_numpy(x), train=True), want)
    new = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"])}
    want_sd = _port_sd({"batch_stats": new["batch_stats"]}, [],
                       build_stats_mapping(encoder), "cnet/", "cnet.")
    own = tenc.state_dict()
    assert set(want_sd) == set(before) and len(before) == 2 * 15
    for k, a in want_sd.items():
        _close(own[k], a, STATS_TOL)
        assert not torch.equal(own[k], before[k]), k
    jeval = _make_encoder(cfg, None, "batch", "cnet", False)
    _close(tenc(torch.from_numpy(x)), _apply(jeval, new, x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_layer_and_its_gradients_match_flax(dtype):
    """The port's BatchNorm against flax's nn.BatchNorm(momentum 0.9, eps
    1e-5) in train mode on (4, 6, 8, 16): output, updated statistics and
    the gradients to the input, scale and bias of a random cotangent
    (f32: 1e-5 relative to each one's largest element); under bf16
    inputs flax computes the statistics in f32 and rounds the output
    (bf16: the outputs within one bf16 ulp, 2^-8 relative)."""
    import flax.linen as fnn

    rng = np.random.default_rng(14)
    x = (1.5 + 2.0 * rng.standard_normal((4, 6, 8, 16))).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)
    v = {"params": {"scale": (1 + 0.1 * rng.standard_normal(16)).astype(
             np.float32),
                    "bias": (0.1 * rng.standard_normal(16)).astype(
             np.float32)},
         "batch_stats": _stats({"mean": np.zeros(16), "var": np.zeros(16)},
                               15)}
    xj = jnp.asarray(x).astype(jdt or jnp.float32)
    tb = BatchNorm(16)
    tb.load_state_dict({
        "weight": torch.from_numpy(v["params"]["scale"]),
        "bias": torch.from_numpy(v["params"]["bias"]),
        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(v["batch_stats"]["var"])})
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = tb(xt, train=True)
    if dtype == "bfloat16":
        want, upd = bn.apply(v, xj, mutable=["batch_stats"])
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(y.detach().float().numpy(), want,
                                   rtol=2.0 ** -8, atol=2.0 ** -8)
    else:
        def f(params, a):
            out, upd = bn.apply({**v, "params": params}, a,
                                mutable=["batch_stats"])
            return jnp.sum(out * ct), (out, upd)
        (_, (want, upd)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(v["params"], xj)
        _close(y.detach(), want, STATS_TOL)
        (y * torch.from_numpy(ct)).sum().backward()
        for got, ref in ((xt.grad, gx), (tb.weight.grad, gp["scale"]),
                         (tb.bias.grad, gp["bias"])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        _close(getattr(tb, name), upd["batch_stats"][key], STATS_TOL)
    assert tb.running_mean.dtype == torch.float32


@pytest.mark.parametrize("train", [False, True])
def test_attn_basic_encoder_matches_jax(train):
    """AttnBasicEncoder on two stacked image pairs: both feature maps and
    the layer-2 self-similarity softmax (BatchNorm in eval and in train
    mode)."""
    x = _clip(4, n=(4,))
    jenc = jbe.AttnBasicEncoder(128, "batch", train)
    v = _variables(jenc, x, seed=9)
    if train:
        want, _ = jax.jit(lambda v, a: jenc.apply(
            v, a, mutable=["batch_stats"]))(v, jnp.asarray(x))
    else:
        want = jax.jit(jenc.apply)(v, jnp.asarray(x))
    rules, stats = _basic_encoder("e", "e", "batch")
    tenc = pbe.AttnBasicEncoder(128, "batch")
    tenc.load_state_dict(_port_sd(v, rules, stats, "e/", "e."))
    got = tenc(torch.from_numpy(x), train=train)
    assert got[2].shape == (2, 16 * 24, 16 * 24) == want[2].shape
    for g, w in zip(got, want):
        _close(g, w)


def test_tiny_attention_four_heads_matches_jax():
    """Res18_3D's hook attention: 4 heads of 16 over T=4 tokens, qkv split
    head by head as JAX's reshape, standard init."""
    x = np.random.default_rng(6).standard_normal((2, 5, 4, 64)).astype(
        np.float32)
    jatt = JTinyAttention(64, num_heads=4, zero_init=False)
    v = _variables(jatt, x, seed=11)
    p = v["params"]
    tatt = TinyAttention(64, num_heads=4, zero_init=False)
    tatt.load_state_dict({
        "qkv.weight": torch.from_numpy(p["qkv_kernel"].T.copy()),
        "proj.weight": torch.from_numpy(p["proj_kernel"].T.copy()),
        "proj.bias": torch.from_numpy(p["proj_bias"])})
    _close(tatt(torch.from_numpy(x)), _apply(jatt, v, x))


def test_temporal_layer_live_init_matches_jax():
    """TemporalLayer(zero_init=False) (``sk_tam_v3_noinit``): both inits
    are flax's standard one (lecun-normal kernels, std 1/sqrt(fan_in)
    within 10%; zero biases; unit norm scales), and on the same random
    weights the two layers agree."""
    x = np.random.default_rng(8).standard_normal((1, 3, 4, 6, 128)).astype(
        np.float32)
    jl = JTemporalLayer(128, zero_init=False)
    tl = TemporalLayer(128, zero_init=False)
    init = jax.jit(jl.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    block = init["params"]["block"]
    kernels = {"attn.qkv": block["attn"]["qkv_kernel"],
               "attn.proj": block["attn"]["proj_kernel"],
               "mlp.fc1": block["mlp"]["fc1_kernel"],
               "mlp.fc2": block["mlp"]["fc2_kernel"]}
    port = dict(tl.transformer_block.named_parameters())
    for name, jk in kernels.items():
        fan_in = np.shape(jk)[0]
        for w in (np.asarray(jk), port[f"{name}.weight"].detach().numpy()):
            assert abs(w.std() * fan_in ** 0.5 - 1) < 0.1, name
    for name, p in port.items():
        if name.endswith("bias"):
            assert not p.any(), name
        elif name.startswith("norm"):
            assert bool((p == 1).all()), name
    v = _variables(jl, x, seed=13)
    rules = [r for r in build_mapping() if "transformer_block" in r[0]]
    tl.load_state_dict(_port_sd(
        v, rules, [], "step/update_block/transformer_block/",
        "update_block.transformer_block."))
    _close(tl(torch.from_numpy(x)), _apply(jl, v, x))
