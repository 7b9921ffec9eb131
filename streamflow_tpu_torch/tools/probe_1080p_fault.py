"""The port's kernels alone at the shapes a 1080x1920 clip gives them, each
probe in a process of its own, so that a fault is attributable and the
other probes survive it.

Port of the JAX package's ``tools/probe_1080p_fault.py`` (which bisected a
TPU worker crash): the same probe registry and shapes, on the port's
kernels. K4 on the Twins stages' window grids (qkv 1x1085x483x384, 4
heads; 1x546x245x768, 8 heads); K1 on 3x135x240x256 fmaps (coordinates
uniform over 200 px; then as the model calls it, 15 chained lookups from
the identity grid, alone, beside K3 on GMA's 32400 tokens, and beside
K2); K3 on GMA (3 x 32400 tokens, d=128) and GSA (518400 and 129600
queries against 8100 keys, d=32); K2 on 97200 rows of 384 with
``gelu="poly"``. Each probe prints OK, its ms (device time of a call, or
of a step of the chained probes: CUDA-graph replays timed by CUDA
events) and its max|err| against the plain version: on every output
where the plain version holds the shape, else on a fixed
sample of query rows (GSA's and GMA's score matrices, K1's volume, K2's
chained inputs), and fails where a value is not finite or an element
breaks chip_smoke's rule (f32 1e-4; bf16 2 ulp + 2^-9 max|plain|).

    python -m streamflow_tpu_torch.tools.probe_1080p_fault   # each apart
    python -m streamflow_tpu_torch.tools.probe_1080p_fault lga1  # in-process
    python -m streamflow_tpu_torch.tools.probe_1080p_fault stress lookup 5

``--lkp_h`` / ``--lkp_w`` (the JAX tool's LKP_H / LKP_W) set the 1/8
grid of the chained probes (default 135 x 240); ``--device cpu`` runs the
plain versions at whatever size the flags give.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys

import torch

from streamflow_tpu_torch.ops.coords import coords_grid
from streamflow_tpu_torch.ops.corr import pool_pyramid
from streamflow_tpu_torch.ops.kernels import corr_lookup as K1
from streamflow_tpu_torch.ops.kernels import ffn_pair as K2
from streamflow_tpu_torch.ops.kernels import flash_attention as K3
from streamflow_tpu_torch.ops.kernels import lga_attention as K4
from streamflow_tpu_torch.tools.common import close_err, fmt_ms, graph_ms

PROBES = {}
CHAIN = 15      # the chained probes' steps (the JAX tool's scan length)
SAMPLE = 256    # query rows the plain version takes where it cannot all


def probe(fn):
    PROBES[fn.__name__] = fn
    return fn


def _rnd(shape, seed, dev, scale=1.0, dt=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, device=dev)).to(dt)


def _rows(n: int, k: int = SAMPLE):
    """A fixed sample of k of n rows, first and last among them."""
    return torch.linspace(0, n - 1, min(k, n)).long()


def _result(value, ms, *pairs):
    """A probe's numbers: its value, ms, and the largest error of its
    (kernel, plain) output pairs, each held to the rule on its own."""
    checks = [close_err(got, want) for got, want in pairs]
    return {"value": float(value), "ms": ms,
            "max_abs_err": max(e for e, _ in checks),
            "ok": all(ok for _, ok in checks) and math.isfinite(float(value))}


def _lga(a, dev, qkv_shape, nh):
    qkv = _rnd(qkv_shape, 0, dev)
    out = K4.lga_attention(qkv, 7, nh)
    ms = graph_ms(lambda: K4.lga_attention(qkv, 7, nh), a.reps, dev)
    return _result(out.float().mean(), ms,
                   (out, K4.lga_attention_plain(qkv, 7, nh)))


@probe
def lga1(a, dev):
    """Twins stage 1 at 1080p: the temporal grid (H/4 * T, W/4), padded."""
    return _lga(a, dev, (1, 1085, 483, 3 * 128), 4)


@probe
def lga2(a, dev):
    return _lga(a, dev, (1, 546, 245, 3 * 256), 8)


def _fmaps(dev, h, w):
    return _rnd((3, h, w, 256), 0, dev), _rnd((3, h, w, 256), 1, dev)


def _lookup_check(f1, levels, coords, out):
    """out against the plain lookup on a sample of image rows."""
    rows = _rows(f1.shape[1], 4)
    want = K1.corr_lookup_plain(f1[:, rows].contiguous(), levels,
                                coords[:, rows].contiguous())
    return out[:, rows], want


@probe
def lookup(a, dev):
    """K1 on the 1080p pyramid, coordinates uniform over 200 px."""
    f1, f2 = _fmaps(dev, 135, 240)
    levels = [lv.contiguous() for lv in pool_pyramid(f2, 4)]
    coords = 200.0 * torch.rand((3, 135, 240, 2), device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(2))
    out = K1.corr_lookup(f1, levels, coords)
    ms = graph_ms(lambda: K1.corr_lookup(f1, levels, coords), a.reps, dev)
    return _result(out.float().mean(), ms,
                   _lookup_check(f1, levels, coords, out))


def _flash(a, dev, bh, n, m, d):
    q, k, v = (_rnd((*bh, nn, d), s, dev)
               for s, nn in ((0, n), (1, m), (2, m)))
    out = K3.flash_attention(q, k, v)
    ms = graph_ms(lambda: K3.flash_attention(q, k, v), a.reps, dev)
    rows = _rows(n)
    return _result(out.float().mean(), ms, (
        out[:, :, rows], K3.flash_attention_plain(q[:, :, rows], k, v)))


@probe
def flash_gma(a, dev):
    """GMA's attention over the 135 x 240 grid, 3 frame pairs, d=128."""
    return _flash(a, dev, (3, 1), 32400, 32400, 128)


@probe
def flash_gsa1(a, dev):
    """Stage-1 GSA: the 1080 x 480 temporal grid's 518400 queries, 4
    heads, against its sr=8 reduction, 135 x 60 = 8100 keys."""
    return _flash(a, dev, (1, 4), 518400, 8100, 32)


@probe
def flash_gsa2(a, dev):
    """Stage-2 GSA: 540 x 240 = 129600 queries, 8 heads, 8100 keys."""
    return _flash(a, dev, (1, 8), 129600, 8100, 32)


def _chain(a, dev, step, checks):
    """CHAIN steps of ``step(c) -> c`` from the identity grid (its first
    step's outputs checked: ``checks(c0)`` returns (got, want) pairs);
    value mean(c), ms a step."""
    c0 = coords_grid(3, a.lkp_h, a.lkp_w, dev)
    pairs = checks(c0)

    def run():
        c = c0
        for _ in range(CHAIN):
            c = step(c)
        return c
    c = run()
    ms = graph_ms(run, 1, dev, warmup=1)
    return _result(c.mean(), None if ms is None else ms / CHAIN, *pairs)


def _pyramid(a, dev):
    f1, f2 = _fmaps(dev, a.lkp_h, a.lkp_w)
    return K1.FusedCorr(f1, f2, 4, 4)


@probe
def lookup_model(a, dev):
    """The in-model pattern: one pyramid, CHAIN chained lookups."""
    pyr = _pyramid(a, dev)

    def step(c):
        return c + pyr.lookup(c).float().mean() + 0.3
    return _chain(a, dev, step, lambda c0: [_lookup_check(
        pyr.f1, pyr.levels, c0, pyr.lookup(c0))])


@probe
def lookup_flash(a, dev):
    """Lookups beside K3 on GMA's tokens (q = k = v), chained."""
    pyr = _pyramid(a, dev)
    q = _rnd((3, 1, a.lkp_h * a.lkp_w, 128), 2, dev)

    def step(c):
        out = pyr.lookup(c)
        att = K3.flash_attention(q, q, q)
        return c + out.float().mean() + att.float().mean() + 0.3

    def checks(c0):
        rows = _rows(q.shape[2])
        return [_lookup_check(pyr.f1, pyr.levels, c0, pyr.lookup(c0)),
                (K3.flash_attention(q, q, q)[:, :, rows],
                 K3.flash_attention_plain(q[:, :, rows], q, q))]
    return _chain(a, dev, step, checks)


def _ffn_operands(dev, rows):
    """The SK-shaped pair's operands: x (rows, 384), weights N(0, 1) (the
    JAX tool's), zero biases."""
    x = _rnd((rows, 384), 2, dev)
    w1, w2 = _rnd((384, 384), 3, dev), _rnd((384, 384), 4, dev)
    b = torch.zeros(384, device=dev, dtype=torch.bfloat16)
    return x, w1, b, w2, b


def _ffn_check(x, w1, b1, w2, b2):
    rows = _rows(x.shape[0])
    return (K2.ffn_pair(x, w1, b1, w2, b2, gelu="poly")[rows],
            K2.ffn_pair_plain(x[rows], w1, b1, w2, b2, gelu="poly"))


@probe
def lookup_ffn(a, dev):
    """Lookups beside K2 (gelu="poly") on the SK blocks' rows, chained."""
    pyr = _pyramid(a, dev)
    ops = _ffn_operands(dev, 3 * a.lkp_h * a.lkp_w)

    def step(c):
        out = pyr.lookup(c)
        y = K2.ffn_pair(*ops, gelu="poly")
        return c + out.float().mean() + y.float().mean() + 0.3
    return _chain(a, dev, step, lambda c0: [
        _lookup_check(pyr.f1, pyr.levels, c0, pyr.lookup(c0)),
        _ffn_check(*ops)])


@probe
def ffn_alone(a, dev):
    """K2 (gelu="poly") alone on 3 x H/8 x W/8 = 97200 rows, CHAIN calls,
    each on the last one's input shifted by its output's mean."""
    x, w1, b1, w2, b2 = _ffn_operands(dev, 3 * a.lkp_h * a.lkp_w)
    shift = torch.zeros((), device=dev, dtype=torch.bfloat16)

    def run():
        c = shift
        for _ in range(CHAIN):
            y = K2.ffn_pair(x + c, w1, b1, w2, b2, gelu="poly")
            c = c + (y.float().mean() * 1e-3).to(torch.bfloat16)
        return c
    pair = _ffn_check(x, w1, b1, w2, b2)
    c = run()
    ms = graph_ms(run, 1, dev, warmup=1)
    return _result(c.float(), None if ms is None else ms / CHAIN, pair)


def run_probe(name: str, a) -> dict:
    """One probe in this process; prints its line, returns its numbers."""
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_1080p_fault: no CUDA device (pass --device "
                         "cpu for the plain versions)")
    r = PROBES[name](a, dev)
    print(f"{name}: {'OK' if r['ok'] else 'FAIL'} ({r['value']:.5f}) "
          f"{fmt_ms(r['ms'])}, max|err| vs plain {r['max_abs_err']:.3e}",
          flush=True)
    if not r["ok"]:
        raise SystemExit(f"{name}: not finite or outside the tolerance")
    return r


def _flags(a):
    return ["--device", a.device, "--reps", str(a.reps), "--lkp_h",
            str(a.lkp_h), "--lkp_w", str(a.lkp_w)]


def run_subprocess(name: str, a, timeout: float = 1500):
    """One probe in a process of its own: (return code, its last line)."""
    r = subprocess.run(
        [sys.executable, "-m", "streamflow_tpu_torch.tools.probe_1080p_fault",
         name, *_flags(a)], capture_output=True, text=True, timeout=timeout)
    tail = (r.stdout + r.stderr).strip().splitlines()[-1:] or [""]
    return r.returncode, tail[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", nargs="*",
                   help="a probe's name, 'stress <probe> <n>', or nothing "
                        "for all probes, each in its own process")
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--lkp_h", type=int, default=135)
    p.add_argument("--lkp_w", type=int, default=240)
    a = p.parse_args(argv)
    if a.what[:1] == ["stress"]:
        name, n = a.what[1], int(a.what[2]) if len(a.what) > 2 else 5
        ok = 0
        for i in range(n):
            rc, _ = run_subprocess(name, a)
            ok += rc == 0
            print(f"  {name} run {i}: {'OK' if rc == 0 else 'CRASH'}",
                  flush=True)
        print(f"stress {name}: {ok}/{n} ok", flush=True)
        return ok == n
    if a.what:
        return run_probe(a.what[0], a)
    failed = []
    for name in PROBES:
        rc, tail = run_subprocess(name, a)
        print(f"{name:12s} {'OK' if rc == 0 else f'FAIL rc={rc}'}  "
              f"{tail[:160]}", flush=True)
        if rc:
            failed.append(name)
    if failed:
        raise SystemExit(f"probe_1080p_fault: {failed} failed")
    return True


if __name__ == "__main__":
    main()
