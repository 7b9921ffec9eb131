"""The port's two-frame baselines (RAFT, RAFT-GMA, SKFlow, and SKFlow
without GMA) against the JAX package's ``models/raft.py::RAFT``, end to
end, and their weight bridge.

- 64x96 pairs, iters=2 (ROADMAP, "Parity tests": random-weight dynamics
  amplify rounding ~2.7x an iteration), f32 on the CPU, every parameter
  and running statistic random from a seed on both sides: test mode
  returns (low-res flow, upsampled flow) as JAX's, with and without
  ``flow_init``; train mode the upsampled flows of every iteration, with
  ``train=True`` (the cnet's BatchNorm on batch statistics) and the
  updated running statistics against JAX's mutable ``batch_stats``.
  Flows reach ~1e3 px (SKFlow), so the tolerance is relative to the
  largest flow: 1e-5 of it at the first iteration plus 1e-4 rtol, times
  2.7 for each iteration after it (tests/test_torch_zoo_model.py's rule;
  SKFlow reads 3.4e-6 of its largest flow after two iterations, RAFT
  8e-7); statistics 1e-5.
- The bridge: ``from_jax`` then ``to_jax_variables`` gives back each
  model's flax variables, ``batch_stats`` included, bit for bit; the
  port's ``build_raft_mapping`` equals JAX's rule for rule; the port's
  tensors are exactly the ones the tables name.
- ``create_model``'s contract for the three names (device, dtypes,
  train) and the config's fields against JAX's ``RAFTConfig``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_raft import (H, ITERS, MODELS, W, close, images, jax_raft,
                         port_raft)
from streamflow_tpu.config import RAFTConfig as JaxRAFTConfig
from streamflow_tpu.convert import torch_import as jti
from streamflow_tpu_torch import convert
from streamflow_tpu_torch.config import RAFTConfig
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import (_flatten, from_jax, load_jax,
                                         to_jax_variables)

torch.set_num_threads(2)
IDS = [m[0] for m in MODELS]


@pytest.fixture(scope="module", params=MODELS, ids=IDS)
def pair(request):
    _, ub, gma = request.param
    jm, v = jax_raft(ub, gma)
    return (ub, gma), jm, v, port_raft(ub, gma, v)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "flow_init"])
def test_test_mode_matches_jax(pair, warm):
    _, jm, v, tm = pair
    a, b = images()
    init = None
    if warm:
        init = (2.0 * np.random.default_rng(4).standard_normal(
            (1, H // 8, W // 8, 2))).astype(np.float32)
    lo, up = jax.jit(lambda v, x, y, fi: jm.apply(
        v, x, y, flow_init=fi, test_mode=True))(
        v, jnp.asarray(a), jnp.asarray(b),
        None if init is None else jnp.asarray(init))
    got_lo, got_up = tm(torch.from_numpy(a), torch.from_numpy(b),
                        flow_init=None if init is None
                        else torch.from_numpy(init), test_mode=True)
    assert got_lo.shape == (1, H // 8, W // 8, 2)
    assert got_up.shape == (1, H, W, 2) and got_up.dtype == torch.float32
    close(got_lo.numpy(), lo, ITERS - 1)
    close(got_up.numpy(), up, ITERS - 1)


def test_train_mode_matches_jax(pair):
    """The per-iteration flows of train mode (test_mode=False) with
    ``train=True``: the cnet's BatchNorm on batch statistics of two pairs,
    and its running statistics' update against JAX's."""
    (ub, gma), jm, v, _ = pair
    tm = port_raft(ub, gma, v, train=True)
    a, b = images(1, b=2)
    want, upd = jax.jit(lambda v, x, y: jm.apply(
        v, x, y, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(a), jnp.asarray(b))
    got = tm(torch.from_numpy(a), torch.from_numpy(b), train=True)
    assert got.shape == (ITERS, 2, H, W, 2) == want.shape
    for i in range(ITERS):
        close(got[i].detach().numpy(), want[i], i)
    got_stats = to_jax_variables(tm.state_dict(), tm.cfg)["batch_stats"]
    want_stats = _flatten(upd["batch_stats"])
    before = _flatten(v["batch_stats"])
    assert set(got_stats) == set(want_stats) and len(got_stats) == 30
    for k, s in want_stats.items():
        np.testing.assert_allclose(got_stats[k], s, atol=1e-5, rtol=1e-5,
                                   err_msg=k)
        assert not np.array_equal(got_stats[k], before[k]), k


def test_bridge_round_trips_bit_for_bit(pair):
    """flax variables -> the port -> flax variables, params and
    batch_stats, bit for bit; the port's state_dict is exactly what the
    tables name."""
    _, _, v, tm = pair
    back = to_jax_variables(tm.state_dict(), tm.cfg)
    assert set(back) == {"params", "batch_stats"}
    for coll in v:
        want = _flatten(v[coll])
        assert set(back[coll]) == set(want), coll
        for k, a in want.items():
            assert back[coll][k].dtype == np.float32
            assert np.array_equal(back[coll][k], a), k
    assert set(from_jax(v, cfg=tm.cfg)) == set(tm.state_dict())
    rules, stats = convert.tables(tm.cfg)
    assert {s for _, s, _ in stats} == {n for n, _ in tm.named_buffers()}
    assert {n for n, _ in tm.named_parameters()} == {
        s for _, s, k in rules if not k.endswith("?")
        or s in tm.state_dict()}


@pytest.mark.parametrize("update_block", ["raft", "gma", "sk"])
def test_build_raft_mapping_equals_jax(update_block):
    """The port's copy of the table, rule for rule (params and
    batch_stats, in JAX's order), at the default and other kernel
    sizes; ``use_gma`` is JAX's rule, GMA with 'gma' and 'sk'."""
    use_gma = update_block in ("gma", "sk")
    for kw in ({}, dict(k_conv=(1, 1, 9), pc_updater_conv=(1, 5))):
        assert (convert.build_raft_mapping(update_block, use_gma, **kw)
                == jti.build_raft_mapping(update_block, **kw))


def test_config_fields_match_jax():
    """The port's RAFTConfig has JAX's fields with JAX's defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxRAFTConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(RAFTConfig)}
    assert pf == jf
    assert RAFTConfig().corr_planes == JaxRAFTConfig().corr_planes == 324
    for ub, gma, want in (("raft", True, False), ("gma", False, True),
                          ("sk", True, True), ("sk", False, False)):
        assert RAFTConfig(update_block=ub, use_gma=gma).uses_gma == want


@pytest.mark.parametrize("name", ["raft", "raft_gma", "skflow"])
def test_create_model_contract(name):
    """The JAX registry's decoders; inference models in bf16 with f32
    BatchNorm (parameters and statistics), training models f32 with
    gradients; the card unless device='cpu'."""
    want = {"raft": ("raft", False), "raft_gma": ("gma", False),
            "skflow": ("sk", True)}[name]
    infer = create_model(name, device="cpu")
    assert (infer.cfg.update_block, infer.cfg.use_gma) == want
    assert (infer.att is None) == (name == "raft")
    bn = {n for n, _ in infer.named_buffers()}
    assert len(bn) == 30 and all(n.startswith("cnet.") for n in bn)
    for n, p in infer.named_parameters():
        want_dt = (torch.float32 if ".norm" in n and n.startswith("cnet.")
                   else torch.bfloat16)
        assert p.dtype == want_dt and not p.requires_grad, n
    assert all(b.dtype == torch.float32 for b in infer.buffers())
    train = create_model(name, device="cpu", train=True, iters=3)
    assert train.cfg.iters == 3 and train.training
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model(name)
    with pytest.raises(KeyError, match="unknown model"):
        create_model("pwcnet", device="cpu")
    with pytest.raises(ValueError, match="encoder='basic'"):
        create_model(name, device="cpu", encoder="twins")


def test_bf16_inference_runs_on_the_cpu():
    """A bf16 SKFlow end to end on the CPU (the plain versions of K1, K2
    and K3 in bf16): finite flows in f32, the low-res flow upsampled by
    8, within 10% of the largest flow of the same weights in f32 (bf16
    rounding alone: 3.6e-2 read at iters=1 on these ~2.7e3 px flows)."""
    v = jax_raft("sk", True)[1]
    tm = create_model("skflow", device="cpu", iters=1)
    load_jax(tm, v)
    a, b = images(2, h=128, w=256)
    lo, up = tm(torch.from_numpy(a), torch.from_numpy(b), test_mode=True)
    assert lo.dtype == up.dtype == torch.float32
    assert up.shape == (1, 128, 256, 2) and bool(torch.isfinite(up).all())
    f32 = port_raft("sk", True, v, iters=1)
    _, ref = f32(torch.from_numpy(a), torch.from_numpy(b), test_mode=True)
    rel = float((up - ref).norm(dim=-1).max() / ref.norm(dim=-1).max())
    assert rel < 0.1, rel
