"""The port's UMT StreamFlow (``encoder="umt"``, ``decoder_dim=768``)
against the JAX package's, on the CPU.

- ``UMT`` alone at depth 2 (768 wide, 12 heads of d=64) against JAX's
  ``layers/umt.py::UMT`` on a (1, 4, 64, 128, 3) clip in [-1, 1]: f32, the
  zoo encoders' tolerance (1e-4 abs and rel: f32 in another summation
  order).
- The plain versions of the kernels at UMT's shapes against JAX's own CPU
  paths, f32, 1e-4 abs and rel: K3 at d=64 (12 heads) and d=384
  (``_flash_xla``), K1 at C=768 (``_xla_equiv_prepared`` on
  ``prepare_inputs``' operands), K2's four forms at the gru's widths
  (1920 -> 2880 -> 1920 / 384, pw 1920) and the joint flow head's (1152
  -> 1728 -> 1152 / 6) (``ffn_pair_xla``).
- The whole model at 1x4x64x128 (a 4x8 grid), with every parameter random
  from a seed (``_torch_parity.randomize_params``) on both sides, f32:
  test mode at iters 1 and 2, and train mode's per-iteration flows at
  iters 2, against JAX's, at tests/test_torch_zoo_model.py's tolerance
  (rtol 1e-4, atol 1e-5 of the largest flow times 2.7 per iteration after
  the first, the growth of rounding per random-weight iteration); in bf16
  at iters=1 the port's flow against JAX's f32 flow within 1.5x of JAX's
  own bf16 flow's relative EPE (tests/test_torch_streamflow_bf16.py's
  rule), at 128x256 (an 8x16 grid).
- The bridge: ``from_jax`` then ``to_jax`` gives back the UMT model's
  flax tree bit for bit, and every tensor of the port is named by its
  table; ``convert_umt_params`` on a synthetic reference state dict (a
  Conv3d patch embedding, ``q_bias`` and ``v_bias``) equals JAX's.
- K2's wide path on tensors that pass for the card's, with a recording
  launcher library: each form's stages, chained; B5 at d=64 and d=384 (one
  launcher call, counted as its two kernels, outputs in the input dtype),
  and refusing another head dim before any launch. The UMT train step
  against JAX's is tests/test_torch_umt_train.py's.
- Both packages fail at JAX's default ``decoder_dim=256``.
- The new modules load neither jax nor the JAX package (a subprocess).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_params
from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.convert.torch_import import \
    convert_umt_params as j_convert_umt_params
from streamflow_tpu.layers.umt import UMT as JUMT
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu.ops.pallas import _ffn_kernel as JK2
from streamflow_tpu.ops.pallas._fused_lookup_kernel import (
    pool_pyramid as j_pool_pyramid, prepare_inputs)
from streamflow_tpu.ops.pallas.attention import _flash_xla
from streamflow_tpu.ops.pallas.corr import _xla_equiv_prepared
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.convert import (build_mapping, build_umt_mapping,
                                          convert_umt_params)
from streamflow_tpu_torch.layers.umt import UMT
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.ops.corr import pool_pyramid
from streamflow_tpu_torch.ops.kernels import ffn_pair as P
from streamflow_tpu_torch.ops.kernels.corr_lookup import corr_lookup_plain
from streamflow_tpu_torch.ops.kernels.flash_attention import \
    flash_attention_plain
from streamflow_tpu_torch.params import _flatten, _from_flat, from_jax
from streamflow_tpu_torch.params import load_jax, to_jax
from streamflow_tpu_torch.tools.common import rel_epe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
T, H, W = 4, 64, 128
BF16_H, BF16_W = 128, 256
BF16_GUARD_RATIO = 1.5
UMT_KW = dict(encoder="umt", decoder_dim=768)


def _images(seed=0, h=H, w=W):
    return np.random.default_rng(seed).integers(
        0, 255, (1, T, h, w, 3)).astype(np.float32)


def _random_variables(module, *args, seed=1, **kw):
    """Random params of a flax module from its init's shapes (nothing
    compiled)."""
    shapes = jax.eval_shape(lambda k, *a: module.init(k, *a, **kw),
                            jax.random.PRNGKey(0),
                            *map(jnp.asarray, args))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        randomize_params(zeros["params"], seed))}


def _umt_rules(depth):
    """The UMT table alone, with the port's one qkv bias."""
    return build_umt_mapping(depth) + [
        (f"block{i}/qkv/bias", f"blocks.{i}.attn.qkv.bias", "raw")
        for i in range(depth)]


def test_umt_encoder_matches_jax():
    x = np.random.default_rng(3).uniform(
        -1, 1, (1, T, H, W, 3)).astype(np.float32)
    jm = JUMT(depth=2)
    v = _random_variables(jm, x)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = UMT(depth=2)
    sd = _from_flat(_flatten(v["params"]), _umt_rules(2), "params")
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, T, H // 16, W // 16, 768)
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------- plain kernels
@pytest.mark.parametrize("bh,n,m,d", [((1, 12), 160, 160, 64),
                                      ((1, 12), 1, 37, 64),
                                      ((3, 1), 96, 96, 384),
                                      ((2, 1), 5, 70, 384)])
def test_flash_plain_matches_jax(bh, n, m, d):
    rng = np.random.default_rng(n + d)
    q = (d ** -0.5 * rng.standard_normal((*bh, n, d))).astype(np.float32)
    k, v = (rng.standard_normal((*bh, m, d)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(_flash_xla(*map(jnp.asarray, (q, k, v))))
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_corr_lookup_plain_matches_jax_at_c768():
    rng = np.random.default_rng(768)
    b, h, w, c, r = 3, 4, 8, 768, 4
    f1, f2 = (rng.standard_normal((b, h, w, c)).astype(np.float32)
              for _ in range(2))
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    coords = (grid[None] + 3.0 * rng.standard_normal((b, h, w, 2))).astype(
        np.float32)
    f1p, f2p, meta = prepare_inputs(jnp.asarray(f1),
                                    j_pool_pyramid(jnp.asarray(f2), 4), r)
    want = np.asarray(_xla_equiv_prepared(f1p, f2p, jnp.asarray(coords),
                                          meta, r))
    got = corr_lookup_plain(torch.from_numpy(f1),
                            pool_pyramid(torch.from_numpy(f2), 4),
                            torch.from_numpy(coords), r)
    assert got.shape == (b, h, w, 4 * 81)
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), **TOL)


def _w(rng, *shape, scale=None):
    scale = shape[0] ** -0.5 if scale is None else scale
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("form", ["ffn_pair_k1", "dwres_pw_ffn_pair",
                                  "ffn_pair", "pw_ffn_pair"])
@pytest.mark.parametrize("c,co", [(1920, 384), (1152, 6)])
def test_ffn_pair_plain_matches_jax_at_umt_widths(form, c, co):
    """The gru's and the joint flow head's pairs (weights (in, out) on the
    JAX side, nn.Linear's (out, in) on the port's)."""
    rng = np.random.default_rng(c + co)
    ch = int(1.5 * c)
    x = rng.standard_normal((1, 3, 5, c)).astype(np.float32)
    out = c if form in ("ffn_pair_k1", "ffn_pair") else co
    w1, b1 = _w(rng, c, ch), _w(rng, ch, scale=0.1)
    w2, b2 = _w(rng, ch, out), _w(rng, out, scale=0.1)
    kw = {}
    if form == "ffn_pair_k1":
        kw = dict(kw=_w(rng, c, scale=0.3), kb=_w(rng, c, scale=0.1))
    if form in ("dwres_pw_ffn_pair", "pw_ffn_pair"):
        kw = dict(wp=_w(rng, c, c), bp=_w(rng, c, scale=0.1))
    if form == "dwres_pw_ffn_pair":
        kw.update(yres=rng.standard_normal(x.shape).astype(np.float32),
                  db=_w(rng, c, scale=0.1))
    residual = form in ("ffn_pair_k1", "ffn_pair")
    want = np.asarray(JK2.ffn_pair_xla(
        *map(jnp.asarray, (x, w1, b1, w2, b2)), residual,
        **{k: jnp.asarray(a) for k, a in kw.items()}))
    tt = {k: torch.from_numpy(a.T.copy() if k == "wp" else a)
          for k, a in kw.items()}
    got = P.ffn_pair_plain(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
                           torch.from_numpy(b1),
                           torch.from_numpy(w2.T.copy()),
                           torch.from_numpy(b2), residual, **tt)
    assert got.shape == want.shape == (1, 3, 5, out)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c,ch,co,pw,dwres,n", [
    (1920, 2880, 1920, False, False, 2), (1920, 2880, 384, True, True, 4),
    (1920, 2880, 384, True, False, 3), (1152, 1728, 6, True, True, 4),
    (640, 960, 128, True, True, 1), (384, 576, 6, True, True, 1)])
def test_k2_launches_per_call(c, ch, co, pw, dwres, n):
    """A K2 call launches once where the fused plan holds its widths (every
    canonical width), else once per stage of the wide path."""
    assert P.wide_launches(c, ch, co, pw, dwres) == n


class _Card(torch.Tensor):
    """A CPU tensor that passes for one on the card (is_cuda), so that a
    wrapper takes its kernel path (tests/test_torch_dw_banded.py's)."""

    @property
    def is_cuda(self):
        return True


def _fake_library(monkeypatch):
    """The kernel library replaced by one that records each launcher call
    (name, arguments) and returns success."""
    from streamflow_tpu_torch import _build

    launched = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or 0
    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 7)
    return launched


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["ffn_pair_k1", "dwres_pw_ffn_pair",
                                  "ffn_pair", "pw_ffn_pair"])
def test_k2_wide_path_chains_its_stages(monkeypatch, form, dt):
    """At the gru's widths each form runs its stages as separate launches:
    the dw residual (sf_ffn_prologue) into the pw product, each product's
    output the next one's A operand, the pair's residual read from the pw
    stage's output (or x), the k1 weights on the last product; one count
    per launch."""
    from streamflow_tpu_torch.ops.kernels import LAUNCHES

    launched = _fake_library(monkeypatch)
    n, c, ch, co = 70, 1920, 2880, 384
    g = torch.Generator().manual_seed(0)

    def card(*shape):
        return torch.randn(*shape, generator=g).to(dt).as_subclass(_Card)
    x = card(1, 7, 10, c)
    w1, b1 = card(ch, c), card(ch)
    pw = form in ("dwres_pw_ffn_pair", "pw_ffn_pair")
    out = co if pw else c
    w2, b2 = card(out, ch), card(out)
    wp, bp = card(c, c), card(c)
    before = LAUNCHES["ffn_pair"]
    if form == "ffn_pair_k1":
        kw, kb = card(c), card(c)
        y = P.ffn_pair_k1(x, w1, b1, w2, b2, kw, kb)
    elif form == "ffn_pair":
        y = P.ffn_pair(x, w1, b1, w2, b2)
    elif form == "pw_ffn_pair":
        y = P.pw_ffn_pair(x, wp, bp, w1, b1, w2, b2)
    else:
        yres, db = card(*x.shape), card(c)
        y = P.dwres_pw_ffn_pair(x, yres, db, wp, bp, w1, b1, w2, b2)
    names = [name for name, _ in launched]
    want = (["sf_ffn_prologue"] if form == "dwres_pw_ffn_pair" else []) + (
        ["sf_ffn_gemm"] * (3 if pw else 2))
    assert names == want
    assert LAUNCHES["ffn_pair"] - before == len(want) == P.wide_launches(
        c, ch, out, pw, form == "dwres_pw_ffn_pair", dt)
    assert y.shape == (1, 7, 10, out) and y.dtype == dt
    gemms = [args for name, args in launched if name == "sf_ffn_gemm"]
    # (a, w, bias, res, kw, kb, out, n, N, K, act, dtype, stream)
    a0 = launched[0][1][3] if form == "dwres_pw_ffn_pair" else x.data_ptr()
    if pw:
        assert gemms[0][:4] == (a0, wp.data_ptr(), bp.data_ptr(), a0)
        assert gemms[0][7:11] == (n, c, c, 0)
        a0 = gemms[0][6]
    h_in, last = gemms[-2], gemms[-1]
    assert h_in[:4] == (a0, w1.data_ptr(), b1.data_ptr(), None)
    assert h_in[7:11] == (n, ch, c, 1)
    assert last[:3] == (h_in[6], w2.data_ptr(), b2.data_ptr())
    assert last[3] == (None if pw else a0)       # the pair's residual
    assert last[4:6] == ((kw.data_ptr(), kb.data_ptr())
                         if form == "ffn_pair_k1" else (None, None))
    assert last[6] == y.data_ptr() and last[7:11] == (n, out, ch, 0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 384])
def test_b5_launches_at_umt_head_dims(monkeypatch, d, dt):
    """B5 at UMT's head dims (the ViT's 64, GMA's 384): one sf_flash_bwd
    call with that d, the inputs' pointers and sizes and the io type's
    code, counted as its two kernels; (dq, dk, dv) come back in the input
    dtype and shapes."""
    from streamflow_tpu_torch.ops.kernels import LAUNCHES
    from streamflow_tpu_torch.ops.kernels import flash_attention as K3

    launched = _fake_library(monkeypatch)
    q, do = (torch.zeros(1, 3, 10, d, dtype=dt).as_subclass(_Card)
             for _ in range(2))
    k, v = (torch.zeros(1, 3, 7, d, dtype=dt).as_subclass(_Card)
            for _ in range(2))
    lse, delta = (torch.zeros(1, 3, 10).as_subclass(_Card) for _ in range(2))
    before = LAUNCHES["flash_attention_bwd"]
    grads = K3.flash_attention_bwd(q, k, v, do, lse, delta)
    assert [name for name, _ in launched] == ["sf_flash_bwd"]
    args = launched[0][1]
    assert args[:6] == tuple(t.data_ptr() for t in (q, k, v, do, lse, delta))
    assert args[9:14] == (3, 10, 7, d, 0 if dt == torch.float32 else 1)
    assert LAUNCHES["flash_attention_bwd"] - before == 2
    for g, t in zip(grads, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dt


def test_b5_still_refuses_other_head_dims(monkeypatch):
    """A head dim B5 has no kernel for (here 96) raises before any
    launch."""
    from streamflow_tpu_torch.ops.kernels import LAUNCHES
    from streamflow_tpu_torch.ops.kernels import flash_attention as K3

    launched = _fake_library(monkeypatch)
    q, k, v, do = (torch.zeros(1, 2, 8, 96).as_subclass(_Card)
                   for _ in range(4))
    lse = torch.zeros(1, 2, 8).as_subclass(_Card)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="head dims"):
        K3.flash_attention_bwd(q, k, v, do, lse, lse)
    assert launched == [] and LAUNCHES == before


# ---------------------------------------------------------- the model
@functools.lru_cache(maxsize=None)
def jax_umt(mixed_precision=False, iters=2, h=H, w=W):
    """The JAX UMT StreamFlow and random variables for it (f32 params,
    from the init's shapes). Callers must not change them."""
    jm = jax_create("streamflow", cfg=JaxConfig(
        T=T, iters=iters, mixed_precision=mixed_precision, **UMT_KW))
    return jm, _random_variables(jm, _images(h=h, w=w), test_mode=True)


def _port(v, iters=2, mixed_precision=False, train=False):
    tm = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=iters, mixed_precision=mixed_precision, **UMT_KW),
        device="cpu", train=train)
    load_jax(tm, v)
    return tm


def _close(got, want, iteration):
    """Flows of refinement iteration ``iteration`` (0-based)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-4,
        atol=1e-5 * 2.7 ** iteration * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def umt_f32():
    jm, v = jax_umt()
    imgs = _images()
    run = jax.jit(lambda v, x, test_mode: jm.apply(
        v, x, test_mode=test_mode), static_argnums=2)
    # JAX's per-iteration flows (train mode) and its test-mode flows
    return v, imgs, np.asarray(run(v, jnp.asarray(imgs), False)), \
        np.asarray(run(v, jnp.asarray(imgs), True))


def test_umt_model_builds_at_decoder_dim_768():
    tm = create_model("streamflow", device="cpu", **UMT_KW)
    ub = tm.update_block
    assert tm.cfg.ratio == 16 and tm.att.dim_head == 384
    assert ub.gru.ffn1[0].in_channels == 1920
    assert ub.flow_head.ffn1[0].in_channels == 1152
    assert ub.mask[2].out_channels == 9 * 16 ** 2
    assert ub.aggregator.dim_head == 384


@pytest.mark.parametrize("iters", [1, 2])
def test_test_mode_matches_jax(umt_f32, iters):
    """Test mode at iters 1 and 2; JAX's test-mode flows after two
    iterations, and its train-mode flows of the first, which are the
    test-mode flows of one iteration (the mask head at the last
    iteration, then the convex upsampling)."""
    v, imgs, per_iter, final = umt_f32
    tm = _port(v)
    got = tm(torch.from_numpy(imgs), iters=iters, test_mode=True)
    assert got.shape == (1, T - 1, H, W, 2)
    want = final if iters == 2 else per_iter[0]
    _close(got.numpy(), want, iters - 1)


def test_train_mode_matches_jax(umt_f32):
    v, imgs, per_iter, _ = umt_f32
    tm = _port(v, train=True)
    got = tm(torch.from_numpy(imgs))
    assert got.shape == (2, 1, T - 1, H, W, 2) == per_iter.shape
    for i in range(2):
        _close(got[i].detach().numpy(), per_iter[i], i)


def test_bf16_within_guard_of_jax():
    imgs = _images(h=BF16_H, w=BF16_W)
    ref_model, v = jax_umt(False, 1, BF16_H, BF16_W)
    bf16_model, _ = jax_umt(True, 1, BF16_H, BF16_W)

    def jax_flow(m):
        return torch.from_numpy(np.array(jax.jit(
            lambda v, x: m.apply(v, x, test_mode=True))(
            v, jnp.asarray(imgs)), np.float32))

    ref, jax_bf16 = jax_flow(ref_model), jax_flow(bf16_model)
    tm = _port(v, iters=1, mixed_precision=True)
    got = tm(torch.from_numpy(imgs), test_mode=True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    port, plain = rel_epe(got, ref), rel_epe(jax_bf16, ref)
    assert all(np.isfinite(port)), port
    assert all(p <= BF16_GUARD_RATIO * j for p, j in zip(port, plain)), (
        port, plain)


# ---------------------------------------------------------- the bridge
def test_bridge_round_trips_bit_for_bit():
    _, v = jax_umt()
    tm = _port(v)
    cfg = tm.cfg
    back = to_jax(tm.state_dict(), cfg=cfg)
    want = _flatten(v["params"])
    assert set(back) == set(want)
    for k, a in want.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], a), k
    assert set(from_jax(v, cfg=cfg)) == set(tm.state_dict())
    rules = build_mapping(encoder="umt")
    assert set(tm.state_dict()) <= {s for _, s, _ in rules}
    assert {s for _, s, k in rules if not k.endswith("?")} <= set(
        tm.state_dict())
    assert tm.state_dict()["fnet.patch_embed.proj.weight"].shape == (
        768, 3, 1, 16, 16)


def test_convert_umt_params_matches_jax():
    """A synthetic reference UMT state dict (Conv3d patch embedding, qkv
    without bias, q_bias and v_bias, 'module.' prefixes) -> the same flax
    tree in both packages."""
    rng = np.random.default_rng(5)
    depth, c = 2, 64
    sd = {"module.patch_embed.proj.weight": rng.standard_normal(
              (c, 3, 1, 16, 16)),
          "module.patch_embed.proj.bias": rng.standard_normal(c)}
    for i in range(depth):
        pre = f"module.blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{pre}.{n}.weight"] = rng.standard_normal(c)
            sd[f"{pre}.{n}.bias"] = rng.standard_normal(c)
        sd[f"{pre}.attn.qkv.weight"] = rng.standard_normal((3 * c, c))
        sd[f"{pre}.attn.q_bias"] = rng.standard_normal(c)
        sd[f"{pre}.attn.v_bias"] = rng.standard_normal(c)
        for n, shape in (("attn.proj", (c, c)), ("mlp.fc1", (4 * c, c)),
                         ("mlp.fc2", (c, 4 * c))):
            sd[f"{pre}.{n}.weight"] = rng.standard_normal(shape)
            sd[f"{pre}.{n}.bias"] = rng.standard_normal(shape[0])
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    got = _flatten(convert_umt_params(sd, depth)["params"])
    want = _flatten(j_convert_umt_params(sd, depth)["params"])
    assert set(got) == set(want)
    for k, a in want.items():
        assert np.array_equal(got[k], a), k
    qkv = got["block1/qkv/bias"]
    assert np.array_equal(qkv[c:2 * c], np.zeros(c, np.float32))
    with pytest.raises(KeyError, match="q/v bias"):
        convert_umt_params({k: a for k, a in sd.items()
                            if "q_bias" not in k}, depth)


def test_both_packages_fail_at_decoder_dim_256():
    with pytest.raises(ValueError, match="decoder_dim=768"):
        create_model("streamflow", device="cpu", encoder="umt")
    jm = jax_create("streamflow", cfg=JaxConfig(
        T=T, iters=1, mixed_precision=False, encoder="umt"))
    with pytest.raises(Exception):
        jax.eval_shape(lambda k, x: jm.init(k, x, test_mode=True),
                       jax.random.PRNGKey(0), jnp.asarray(_images()))


def test_new_modules_never_import_jax():
    """The UMT encoder, the temporal aggregates and a UMT model's forward
    load neither jax nor the JAX package."""
    code = """
import sys
import torch
import streamflow_tpu_torch.layers
from streamflow_tpu_torch.layers.umt import UMT
from streamflow_tpu_torch.layers.gma import TMMAggregate
from streamflow_tpu_torch.convert import convert_umt_params
from streamflow_tpu_torch.models import create_model
m = create_model("streamflow", device="cpu", encoder="umt", decoder_dim=768,
                 iters=1, mixed_precision=False)
assert m(torch.zeros(1, 4, 32, 32, 3), test_mode=True).shape == (
    1, 3, 32, 32, 2)
assert "jax" not in sys.modules, "jax imported"
bad = [m for m in sys.modules if m.split(".")[0] == "streamflow_tpu"]
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
