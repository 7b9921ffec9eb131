"""The port's StreamFlow in the ablation configs against the JAX package's,
end to end, and the weight bridge of every config.

- The decoder branches (``sk_tam_v1``'s per-frame flow head,
  ``sk_tam_v3_noinit``'s live temporal layer, ``use_gma=False``) on the
  canonical encoder, and the CNN encoder ``basic`` (BatchNorm cnet), at
  64x96, T=4, iters=2 (ROADMAP, "Parity tests": random-weight dynamics
  amplify rounding ~2.7x an iteration), f32 on the CPU, with every
  parameter and running statistic random from a seed on both sides: test
  mode, and train mode (the per-iteration flows), with ``train=True`` for
  ``basic`` (BatchNorm on batch statistics; the updated statistics too).
  Flows reach ~1e3 px, so the tolerance is relative to the largest flow:
  1e-5 of it at the first iteration plus 1e-4 rtol
  (tests/test_torch_model.py's), times 2.7 for each iteration after it,
  the growth of rounding per random-weight iteration (ROADMAP, "Parity
  tests"; the per-frame flow head of ``sk_tam_v1`` reads 3e-6 of the
  largest flow after one iteration and up to 1.2e-5 after two, the
  canonical head 2e-6 and 3e-6); statistics 1e-5.
- The bridge: ``from_jax`` then ``to_jax_variables`` gives back each
  config's flax tree, ``batch_stats`` included, bit for bit; every
  encoder x decoder x ``use_gma`` builds, and its tensors are exactly the
  ones its tables name.
- ``encoder="umt"`` raises at JAX's default ``decoder_dim=256`` (it runs
  at 768 only: tests/test_torch_umt.py), as an unknown encoder or
  update block does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_params
from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.convert import (build_mapping, build_stats_mapping,
                                          table_kwargs)
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import (_flatten, from_jax, load_jax,
                                         to_jax_variables)

torch.set_num_threads(2)
T, H, W, ITERS = 4, 64, 96, 2
ENCODERS = ["twins_csc", "twins", "twins_1dconv", "twins_temporal_attention",
            "twins_3dconv", "basic", "resnet18", "mf_basic", "res18_3d"]
DECODERS = ["sk_tam_v3", "sk_tam_v1", "sk_tam_v3_noinit"]
# (encoder, update_block, use_gma) of the end-to-end parity tests
PARITY = [("twins_csc", "sk_tam_v1", True),
          ("twins_csc", "sk_tam_v3_noinit", True),
          ("twins_csc", "sk_tam_v3", False),
          ("basic", "sk_tam_v3", True)]


def _images(seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (1, T, H, W, 3)).astype(np.float32)


def _stats(tree, seed):
    """Running statistics: means 0.1 r, variances 0.5 + u."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if hasattr(v, "items") else (
            (0.5 + rng.random(np.shape(v))) if k == "var"
            else 0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in node.items()}
    return walk(tree)


def _kw(encoder, update_block, use_gma):
    return dict(T=T, iters=ITERS, mixed_precision=False, encoder=encoder,
                update_block=update_block, use_gma=use_gma)


@functools.lru_cache(maxsize=None)
def jax_variables(encoder, update_block="sk_tam_v3", use_gma=True, seed=1):
    """The JAX StreamFlow of a config and random variables for it (f32;
    from the init's shapes, nothing compiled). Callers must not change
    them."""
    jm = jax_create("streamflow", cfg=JaxConfig(**_kw(encoder, update_block,
                                                      use_gma)))
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, test_mode=True),
                            jax.random.PRNGKey(0), jnp.asarray(_images()))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    v = {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        randomize_params(zeros["params"], seed))}
    if "batch_stats" in zeros:
        v["batch_stats"] = _stats(zeros["batch_stats"], seed + 1)
    return jm, v


def _port(encoder, update_block, use_gma, variables, train=False):
    tm = create_model("streamflow", cfg=StreamFlowConfig(
        **_kw(encoder, update_block, use_gma)), device="cpu", train=train)
    load_jax(tm, variables)
    return tm


def _close(got, want, iteration):
    """Flows of refinement iteration ``iteration`` (0-based)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-4,
        atol=1e-5 * 2.7 ** iteration * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module", params=PARITY,
                ids=["-".join(map(str, p)) for p in PARITY])
def pair(request):
    encoder, ub, gma = request.param
    jm, v = jax_variables(encoder, ub, gma)
    return request.param, jm, v, _port(encoder, ub, gma, v)


def test_test_mode_matches_jax(pair):
    _, jm, v, tm = pair
    imgs = _images()
    want = jax.jit(lambda v, x: jm.apply(v, x, test_mode=True))(
        v, jnp.asarray(imgs))
    got = tm(torch.from_numpy(imgs), test_mode=True)
    assert got.shape == (1, T - 1, H, W, 2)
    _close(got.numpy(), want, ITERS - 1)


def test_train_mode_matches_jax(pair):
    """The per-iteration flows of train mode (test_mode=False), with
    ``train=True`` where the config has BatchNorm: its batch statistics
    and the running statistics' update against JAX's mutable
    ``batch_stats``."""
    (encoder, ub, gma), jm, v, _ = pair
    tm = _port(encoder, ub, gma, v, train=True)
    imgs = _images(1)
    bn = "batch_stats" in v
    fn = jax.jit(lambda v, x: jm.apply(v, x, train=bn, **(
        {"mutable": ["batch_stats"]} if bn else {})))
    out = fn(v, jnp.asarray(imgs))
    want, upd = out if bn else (out, None)
    got = tm(torch.from_numpy(imgs), train=bn)
    assert got.shape == (ITERS, 1, T - 1, H, W, 2) == want.shape
    for i in range(ITERS):
        _close(got[i].detach().numpy(), want[i], i)
    if bn:
        got_stats = to_jax_variables(tm.state_dict(), tm.cfg)["batch_stats"]
        want_stats = _flatten(upd["batch_stats"])
        assert set(got_stats) == set(want_stats) and len(got_stats) == 30
        for k, a in want_stats.items():
            np.testing.assert_allclose(got_stats[k], a, atol=1e-5,
                                       rtol=1e-5, err_msg=k)


BRIDGED = ([(e, "sk_tam_v3", True) for e in ENCODERS]
           + [("twins_csc", u, g) for u in DECODERS for g in (True, False)
              if (u, g) != ("sk_tam_v3", True)]
           + [("res18_3d", "sk_tam_v1", False)])


@pytest.mark.parametrize("config", BRIDGED,
                         ids=["-".join(map(str, c)) for c in BRIDGED])
def test_bridge_round_trips_bit_for_bit(config):
    """flax variables -> the port -> flax variables, params and
    batch_stats, bit for bit, and the port's state_dict is exactly what
    the tables name."""
    _, v = jax_variables(*config)
    tm = _port(*config, v)
    back = to_jax_variables(tm.state_dict(), tm.cfg)
    assert set(back) == set(v)
    for coll in v:
        want = _flatten(v[coll])
        assert set(back[coll]) == set(want), coll
        for k, a in want.items():
            assert back[coll][k].dtype == np.float32
            assert np.array_equal(back[coll][k], a), k
    sd = from_jax(v, cfg=tm.cfg)
    assert set(sd) == set(tm.state_dict())


@pytest.mark.parametrize("encoder", ENCODERS)
def test_every_config_builds(encoder):
    """create_model takes every encoder x update_block x use_gma of the
    JAX config but UMT; its tensors are the ones the tables name, no more;
    the CNN encoders' running statistics are buffers, kept f32 in a bf16
    inference model; the Twins family has none."""
    for ub in DECODERS:
        for gma in (True, False):
            cfg = StreamFlowConfig(encoder=encoder, update_block=ub,
                                   use_gma=gma)
            tm = create_model("streamflow", cfg=cfg, device="cpu")
            kw = table_kwargs(cfg)
            named = {s for _, s, k in build_mapping(**kw)}
            stats = {s for _, s, _ in build_stats_mapping(encoder)}
            assert set(tm.state_dict()) <= named | stats
            assert {n for n, _ in tm.named_parameters()} == {
                s for _, s, k in build_mapping(**kw) if not k.endswith("?")
                or s in tm.state_dict()}
            buffers = dict(tm.named_buffers())
            assert set(buffers) == stats
            assert (len(stats) == 30) == (encoder not in ENCODERS[:5])
            assert all(b.dtype == torch.float32 for b in buffers.values())
            assert (tm.att is None) == (not gma)
            assert (tm.update_block.aggregator is None) == (not gma)
            head = tm.update_block.flow_head.ffn2[2]
            assert head.out_channels == (2 if ub == "sk_tam_v1" else 6)


def test_umt_raises():
    for build in (lambda: create_model("streamflow", device="cpu",
                                       encoder="umt"),
                  lambda: create_model("streamflow", device="cpu",
                                       encoder="umt", train=True)):
        with pytest.raises(ValueError, match="decoder_dim=768"):
            build()
    with pytest.raises(ValueError, match="unknown encoder"):
        create_model("streamflow", device="cpu", encoder="vit")
    with pytest.raises(ValueError, match="unknown update_block"):
        create_model("streamflow", device="cpu", update_block="sk_tam_v2")
