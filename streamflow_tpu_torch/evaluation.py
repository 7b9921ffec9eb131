"""Dataset validators of the port (port of streamflow_tpu/evaluation.py;
reference evaluate_mf.py): Sintel clean/final EPE + threshold metrics,
KITTI EPE + F1-all, Spring EPE + 1px by speed band, FlyingThings
multi-frame EPE, tiled KITTI, the occlusion split and the worst-case miner,
with the tail-window dedup (-1 frame ids) exactly as the reference counts
them. The weights live in the model, so the validators take the JAX
signatures without ``params``. The metric reductions run on NumPy, as in
JAX.

Every forward goes through ``GraphedForward``: one CUDA graph per padded
shape (every Sintel frame is 436x1024, every KITTI frame is padded to one
of the fixed kitti buckets), replayed as one host call per window. A
validator takes a model, and builds its own ``GraphedForward``, or a
``GraphedForward`` that the caller holds (the trainer keeps one for the
whole run). The per-window steps (``window_flows``, ``tiled_window_flows``, ``pair_epes``,
``kitti_pair_metrics``) take any clip, from a dataset or from memory.

The two-frame baselines (RAFT, RAFT-GMA, SKFlow) have their own
forward, ``GraphedForward2F`` (one CUDA graph per input shape, JAX's
``JittedForward2F``), and validators, ``validate_chairs``,
``validate_things`` and ``validate_sintel_2f``.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from streamflow_tpu_torch.data import mf_datasets
from streamflow_tpu_torch.ops.padding import InputPadder
from streamflow_tpu_torch.utils import profiling
from streamflow_tpu_torch.utils.profiling import span


class _Bucket:
    """One input shape's static buffers, graph and outputs (graph None on
    the CPU, where the forward runs eagerly), and the device spans
    captured into the graph (``utils.profiling.capturing``)."""

    def __init__(self, graph=None, images=None, flow_init=None, out=None,
                 spans=None):
        self.graph = graph
        self.images = images
        self.flow_init = flow_init
        self.out = out
        self.spans = spans


class GraphedForward:
    """Shape-bucketed test-mode forward of a model: the counterpart of
    streamflow_tpu/evaluation.py::JittedForward (:24-43), which compiles one
    executable per padded shape. Here each bucket is one CUDA graph.

    ``fwd(images)`` -> flows (B, T-1, H, W, 2); ``fwd(images, flow_init)``
    -> (flows, lowres), as ``StreamFlow.forward(..., test_mode=True)``.

    Bucket key: the input's shape, dtype and device, whether ``flow_init``
    is given, and ``iters``. The first call of a bucket allocates its
    static inputs, runs two eager forwards on a side stream (they
    build the kernel library, look up the TMA encoder and settle cuDNN's
    choices outside the capture), then captures one forward with
    ``torch.cuda.graph``. All buckets share one memory pool: one runs at a
    time. Each call copies the input into the bucket's buffers, replays
    the graph and returns clones of its outputs, since the next replay
    overwrites them (the warm start keeps the previous window's low-res
    flow; the tiled forward blends tile after tile).

    A model on the CPU runs eagerly with the same API. On the card a capture
    that fails raises, naming the bucket; nothing falls back to eager.
    ``keep_graphs`` keeps each bucket's cudaGraph_t beside its executable
    (torch's ``keep_graph``), so that its nodes can be read
    (tools/common.py::graph_kernel_nodes).

    Spans (``utils.profiling``, while the recorder is on): each call is a
    ``serve`` unit holding ``serve.copy_in``, ``serve.replay`` and
    ``serve.copy_out``; a capture adds ``serve.warmup`` and
    ``serve.capture``. A bucket captured with the recorder on holds the
    model's device spans as event nodes of its graph, and each call reads
    the previous replay's before it replays; with the recorder off at the
    capture the graph is the same, node for node, as without spans.
    """

    def __init__(self, model, iters: int, keep_graphs: bool = False):
        self.model = model
        self.iters = iters
        self.keep_graphs = keep_graphs
        self.device = next(model.parameters()).device
        self.buckets: Dict[tuple, _Bucket] = {}
        self._pool = None

    def _forward(self, images, flow_init):
        return self.model(images, iters=self.iters, flow_init=flow_init,
                          test_mode=True)

    def __call__(self, images: torch.Tensor,
                 flow_init: Optional[torch.Tensor] = None):
        with span("serve"):
            key = (tuple(images.shape), images.dtype, images.device,
                   flow_init is not None, self.iters)
            bucket = self.buckets.get(key)
            if bucket is None:
                bucket = self.buckets[key] = (
                    self._capture(key, images, flow_init)
                    if self.device.type == "cuda" else _Bucket())
            if bucket.graph is None:
                return self._forward(images, flow_init)
            with span("serve.copy_in"):
                bucket.images.copy_(images)
                if flow_init is not None:
                    bucket.flow_init.copy_(flow_init)
            with span("serve.replay"):
                profiling.replay(bucket.spans)
                bucket.graph.replay()
            with span("serve.copy_out"):
                if isinstance(bucket.out, tuple):
                    return tuple(o.clone() for o in bucket.out)
                return bucket.out.clone()

    def _capture(self, key, images, flow_init) -> _Bucket:
        dev = self.device
        x = images.to(dev, copy=True)
        fi = None if flow_init is None else flow_init.to(dev, copy=True)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with span("serve.warmup"), torch.cuda.stream(side):
            for _ in range(2):
                self._forward(x, fi)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graphs)
        try:
            with span("serve.capture"), profiling.capturing() as spans:
                with torch.cuda.graph(graph, pool=self._pool):
                    out = self._forward(x, fi)
            if self.keep_graphs:
                graph.instantiate()
        except RuntimeError as e:
            raise RuntimeError(
                f"GraphedForward: capture of bucket (shape, dtype, device, "
                f"flow_init, iters) = {key} failed: {e}") from e
        return _Bucket(graph, x, fi, out, spans)


class GraphedForward2F(GraphedForward):
    """Shape-bucketed test-mode forward of a two-frame model (RAFT,
    RAFT-GMA, SKFlow): the counterpart of streamflow_tpu/evaluation.py::
    JittedForward2F (:224-246). ``fwd(im1, im2)`` (each (B, H, W, 3)) ->
    the upsampled flow (B, H, W, 2). One CUDA graph per input shape, as
    GraphedForward: the pair is held as one (B, 2, H, W, 3) static
    input."""

    def _forward(self, images, flow_init):
        return self.model(images[:, 0], images[:, 1], iters=self.iters,
                          test_mode=True)[1]

    def __call__(self, im1: torch.Tensor, im2: torch.Tensor):
        return super().__call__(torch.stack([im1, im2], dim=1))


def graphed(model, iters: int, cls=GraphedForward) -> GraphedForward:
    """``model`` itself if it is a ``cls`` (GraphedForward, or
    GraphedForward2F for a two-frame model) of ``iters`` iterations, else
    a new ``cls`` of it."""
    if not isinstance(model, cls):
        return cls(model, iters)
    if model.iters != iters:
        raise ValueError(f"a GraphedForward of {model.iters} iterations "
                         f"given for {iters}")
    return model


def _epe_map(flow, gt):
    return np.sqrt(((flow - gt) ** 2).sum(-1))


def _clip(images: np.ndarray, device) -> torch.Tensor:
    """A (T, H, W, 3) NumPy clip as a (1, T, H, W, 3) f32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        images[None], np.float32)).to(device)


def window_flows(fwd, images: np.ndarray, device, mode: str = "sintel"
                 ) -> np.ndarray:
    """One eval window: the (T, H, W, 3) clip padded in ``mode``, through
    ``fwd``, unpadded -> (T-1, H, W, 2) f32 NumPy flows."""
    x = _clip(images, device)
    padder = InputPadder(x.shape[-3:], mode=mode)
    return padder.unpad(fwd(padder.pad(x)))[0].float().cpu().numpy()


def tiled_window_flows(fwd, images: np.ndarray, device,
                       patch_size=(432, 960), min_overlap: int = 20,
                       sigma: float = 0.05) -> np.ndarray:
    """One window of the tiled KITTI validation: padded in 'kitti432', then
    blended patches of ``patch_size`` (one forward if the padded clip is
    smaller than a patch) -> (T-1, H, W, 2) f32 NumPy flows."""
    from streamflow_tpu_torch.tiling import tiled_forward

    x = _clip(images, device)
    padder = InputPadder(x.shape[-3:], mode="kitti432")
    padded = padder.pad(x)
    if padded.shape[2] < patch_size[0] or padded.shape[3] < patch_size[1]:
        flows = fwd(padded)
    else:
        flows = tiled_forward(fwd, padded, patch_size=patch_size,
                              min_overlap=min_overlap, sigma=sigma)
    return padder.unpad(flows)[0].float().cpu().numpy()


def warm_window_flows(fwd, images: np.ndarray, device,
                      warm: Optional[np.ndarray], ratio: int = 8
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One warm-started window: the clip padded in 'sintel' mode, through
    ``fwd`` with ``flow_init`` = ``warm`` (zeros where ``warm`` is None, at
    the first window of a scene) -> the unpadded (T-1, H, W, 2) flows and
    the next window's ``warm``, its low-res flows forward-interpolated pair
    by pair (evaluate_mf.py:304-305)."""
    from streamflow_tpu_torch.ops.warp import per_pair_warm_start

    x = _clip(images, device)
    padder = InputPadder(x.shape[-3:], mode="sintel")
    ph, pw = padder.padded_shape
    if warm is None:
        warm = np.zeros((1, x.shape[1] - 1, ph // ratio, pw // ratio, 2),
                        np.float32)
    flows, lowres = fwd(padder.pad(x), torch.from_numpy(warm).to(device))
    return (padder.unpad(flows)[0].float().cpu().numpy(),
            per_pair_warm_start(lowres[0].float().cpu().numpy()))


def pair_epes(flows: np.ndarray, sample, nframes: int) -> List[np.ndarray]:
    """Per-pixel EPE of each pair not marked a duplicate (frame id -1)."""
    return [_epe_map(flows[p], sample["flows"][p]).reshape(-1)
            for p in range(nframes - 1) if sample["frame_ids"][p] != -1]


def kitti_pair_metrics(flows: np.ndarray, sample, nframes: int
                       ) -> Tuple[float, np.ndarray]:
    """The final pair's mean EPE over valid (>= 0.5) pixels and its
    per-pixel outliers there, epe > 3 and epe / |gt| > 0.05 (reference
    validate_kitti_mf, evaluate_mf.py:107-142)."""
    p = nframes - 2  # final pair carries the GT
    gt, valid = sample["flows"][p], sample["valids"][p] >= 0.5
    epe = _epe_map(flows[p], gt).reshape(-1)
    mag = np.sqrt((gt ** 2).sum(-1)).reshape(-1)
    v = valid.reshape(-1)
    out = (epe > 3.0) & ((epe / np.maximum(mag, 1e-12)) > 0.05)
    return epe[v].mean(), out[v]


def validate_sintel(model, root="datasets/sintel", iters=15, nframes=4,
                    dstypes=("clean", "final"),
                    progress: bool = True) -> Dict[str, float]:
    """Reference validate_sintel_mf (evaluate_mf.py:469-503)."""
    fwd = graphed(model, iters)
    results = {}
    for dstype in dstypes:
        ds = mf_datasets.SintelMultiframeEval(split="training", dstype=dstype,
                                              root=root, nframes=nframes)
        epes = []
        t0 = time.time()
        for i in range(len(ds)):
            s = ds.load(i)
            flows = window_flows(fwd, s["images"], fwd.device)
            epes += pair_epes(flows, s, nframes)
            if progress and i % 50 == 0:
                print(f"  sintel-{dstype} {i}/{len(ds)} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        epe_all = np.concatenate(epes)
        results[f"{dstype}_epe"] = float(epe_all.mean())
        results[f"{dstype}_1px"] = float((epe_all < 1).mean())
        results[f"{dstype}_3px"] = float((epe_all < 3).mean())
        results[f"{dstype}_5px"] = float((epe_all < 5).mean())
        print(f"Validation ({dstype}) EPE: {results[f'{dstype}_epe']:.4f}, "
              f"1px: {results[f'{dstype}_1px']:.4f}, "
              f"3px: {results[f'{dstype}_3px']:.4f}, "
              f"5px: {results[f'{dstype}_5px']:.4f}")
    return results


def validate_sintel_warm(model, root="datasets/sintel", iters=15, nframes=4,
                         dstypes=("clean", "final"), ratio=8,
                         progress: bool = True) -> Dict[str, float]:
    """Warm-start Sintel validation: each window is initialized with the
    forward-interpolated low-res flow of the previous window in the same
    scene (the submission-side warm start, evaluate_mf.py:288-322, applied
    to the training split, as the JAX package does)."""
    fwd = graphed(model, iters)
    results = {}
    for dstype in dstypes:
        ds = mf_datasets.SintelMultiframeEval(split="training", dstype=dstype,
                                              root=root, nframes=nframes)
        epes = []
        prev_scene, warm = None, None
        for i in range(len(ds)):
            rec = ds.records[i]
            s = ds.load(i)
            flows, warm = warm_window_flows(
                fwd, s["images"], fwd.device,
                warm if rec.scene == prev_scene else None, ratio)
            prev_scene = rec.scene
            epes += pair_epes(flows, s, nframes)
            if progress and i % 50 == 0:
                print(f"  sintel-warm-{dstype} {i}/{len(ds)}", flush=True)
        epe_all = np.concatenate(epes)
        results[f"{dstype}_warm_epe"] = float(epe_all.mean())
        results[f"{dstype}_warm_1px"] = float((epe_all < 1).mean())
        print(f"Validation warm ({dstype}) EPE: "
              f"{results[f'{dstype}_warm_epe']:.4f}")
    return results


def validate_kitti(model, multi_root="datasets/multi-kitti", iters=15,
                   nframes=4) -> Dict[str, float]:
    """Reference validate_kitti_mf (evaluate_mf.py:107-142):
    F1-all = mean over valid px of (epe > 3 AND epe/mag > 0.05)."""
    fwd = graphed(model, iters)
    ds = mf_datasets.KITTIMultiFrameEval(multi_root=multi_root,
                                         split="training", nframes=nframes)
    epe_list, out_list = [], []
    for i in range(len(ds)):
        s = ds.load(i)
        flows = window_flows(fwd, s["images"], fwd.device, mode="kitti")
        epe, out = kitti_pair_metrics(flows, s, nframes)
        epe_list.append(epe)
        out_list.append(out)
    epe = float(np.mean(epe_list))
    f1 = float(100 * np.concatenate(out_list).mean())
    print(f"Validation KITTI: {epe:.4f}, {f1:.4f}")
    return {"kitti_epe": epe, "kitti_f1": f1}


def validate_spring(model, root="datasets/spring", iters=15, nframes=4,
                    progress: bool = True) -> Dict[str, float]:
    """Reference validate_spring_mf (evaluate_mf.py:51-102): NaN GT marks
    invalid pixels; 1px outlier rates split by speed band. EPE and 1px
    are taken over valid pixels only, as in the JAX package (PARITY.md)."""
    fwd = graphed(model, iters)
    ds = mf_datasets.SpringVal(root=osp.join(root, "train"), nframes=nframes,
                               subsample_groundtruth=True)
    epes, e10, e10_40, e40 = [], [], [], []
    for i in range(len(ds)):
        s = ds.load(i)
        flows = window_flows(fwd, s["images"], fwd.device)
        for p in range(nframes - 1):
            if s["frame_ids"][p] == -1:
                continue
            gt = s["flows"][p]
            valid = ~np.isnan(gt.sum(-1))
            mag = np.sqrt((np.nan_to_num(gt) ** 2).sum(-1))
            epe = _epe_map(flows[p], np.nan_to_num(gt))
            epes.append(epe[valid].reshape(-1))
            e10.append(epe[valid & (mag < 10)].reshape(-1))
            e10_40.append(epe[valid & (mag >= 10) & (mag < 40)].reshape(-1))
            e40.append(epe[valid & (mag >= 40)].reshape(-1))
        if progress and i % 20 == 0:
            print(f"  spring {i}/{len(ds)}", flush=True)
    epe_all = np.concatenate(epes)

    def _rate(parts):
        v = np.concatenate(parts)
        return float((v > 1).mean()) if v.size else float("nan")

    res = {
        "spring_epe": float(epe_all.mean()),
        "spring_1px": float((epe_all > 1).mean()),
        "spring_1px_s0_10": _rate(e10),
        "spring_1px_s10_40": _rate(e10_40),
        "spring_1px_s40": _rate(e40),
    }
    print(f"Spring EPE: {res['spring_epe']:.4f}, 1px: {res['spring_1px']:.4f} "
          f"(s0-10 {res['spring_1px_s0_10']:.4f}, "
          f"s10-40 {res['spring_1px_s10_40']:.4f}, "
          f"s40+ {res['spring_1px_s40']:.4f})")
    return res


def validate_things_mf(model, root="datasets/flyingthings3d", iters=15,
                       nframes=4) -> Dict[str, float]:
    """Multi-frame FlyingThings validation: T-frame windows over the TEST
    split, every pair's EPE counted once (stride-1 windows: each window's
    last pair, plus the leading pairs of each sequence's first window)."""
    fwd = graphed(model, iters)
    results = {}
    for dstype in ["frames_cleanpass", "frames_finalpass"]:
        ds = mf_datasets.FlyingThings3DMultiFrame(
            None, root=root, dstype=dstype, split="validation",
            nframes=nframes)
        epes = []
        prev_scene = None
        for i in range(len(ds)):
            rec = ds.records[i]
            s = ds.load(i)
            flows = window_flows(fwd, s["images"], fwd.device)
            pairs = (range(nframes - 1) if rec.scene != prev_scene
                     else [nframes - 2])
            for p in pairs:
                epes.append(_epe_map(flows[p], s["flows"][p]).reshape(-1))
            prev_scene = rec.scene
        epe_all = np.concatenate(epes)
        tag = dstype.replace("frames_", "").replace("pass", "")
        results[f"things_{tag}_epe"] = float(epe_all.mean())
        print(f"Validation mf ({dstype}) EPE: {epe_all.mean():.4f}, "
              f"1px: {(epe_all < 1).mean():.4f}")
    return results


def pair_flow(fwd, images: np.ndarray, device,
              mode: Optional[str] = "sintel") -> np.ndarray:
    """One two-frame eval pair: the (2, H, W, 3) images padded in
    ``mode`` (None: as they are), through ``fwd`` (a GraphedForward2F),
    unpadded -> the (H, W, 2) f32 NumPy flow."""
    x = _clip(images, device)
    padder = InputPadder(x.shape[-3:], mode=mode) if mode else None
    if padder is not None:
        x = padder.pad(x)
    flow = fwd(x[:, 0], x[:, 1])
    if padder is not None:
        flow = padder.unpad(flow)
    return flow[0].float().cpu().numpy()


def validate_chairs(model, root="datasets/FlyingChairs_release/data",
                    iters=24) -> Dict[str, float]:
    """Two-frame FlyingChairs validation split, unpadded (384x512;
    reference validate_chairs, evaluate_mf.py:375-400)."""
    from streamflow_tpu_torch.data.datasets import FlyingChairs

    fwd = graphed(model, iters, GraphedForward2F)
    ds = FlyingChairs(None, split="validation", root=root)
    epes = []
    for i in range(len(ds)):
        s = ds.load(i)
        flow = pair_flow(fwd, s["images"], fwd.device, mode=None)
        epes.append(_epe_map(flow, s["flows"][0]).reshape(-1))
    epe = float(np.concatenate(epes).mean())
    print(f"Validation Chairs EPE: {epe:.4f}")
    return {"chairs_epe": epe}


def validate_things(model, root="datasets/flyingthings3d",
                    iters=24) -> Dict[str, float]:
    """Two-frame FlyingThings validation (TEST) split, clean and final,
    padded in 'sintel' mode (reference validate_things,
    evaluate_mf.py:396-429)."""
    from streamflow_tpu_torch.data.datasets import FlyingThings3D

    fwd = graphed(model, iters, GraphedForward2F)
    results = {}
    for dstype in ["frames_cleanpass", "frames_finalpass"]:
        ds = FlyingThings3D(None, root=root, dstype=dstype,
                            split="validation")
        epes = []
        for i in range(len(ds)):
            s = ds.load(i)
            flow = pair_flow(fwd, s["images"], fwd.device)
            epes.append(_epe_map(flow, s["flows"][0]).reshape(-1))
        epe_all = np.concatenate(epes)
        tag = dstype.replace("frames_", "").replace("pass", "")
        results[f"things_{tag}_epe"] = float(epe_all.mean())
        print(f"Validation ({dstype}) EPE: {epe_all.mean():.4f}, "
              f"1px: {(epe_all < 1).mean():.4f}, "
              f"3px: {(epe_all < 3).mean():.4f}, "
              f"5px: {(epe_all < 5).mean():.4f}")
    return results


def validate_sintel_2f(model, root="datasets/sintel", iters=32,
                       dstypes=("clean", "final")) -> Dict[str, float]:
    """Two-frame Sintel validation of the RAFT-family baselines, padded in
    'sintel' mode (436x1024 -> 440x1024; reference validate_sintel,
    evaluate_mf.py:405-440)."""
    from streamflow_tpu_torch.data.datasets import MpiSintel

    fwd = graphed(model, iters, GraphedForward2F)
    results = {}
    for dstype in dstypes:
        ds = MpiSintel(None, split="training", root=root, dstype=dstype)
        epes = []
        for i in range(len(ds)):
            s = ds.load(i)
            flow = pair_flow(fwd, s["images"], fwd.device)
            epes.append(_epe_map(flow, s["flows"][0]).reshape(-1))
        epe_all = np.concatenate(epes)
        results[f"{dstype}_epe_2f"] = float(epe_all.mean())
        print(f"Validation 2f ({dstype}) EPE: "
              f"{results[f'{dstype}_epe_2f']:.4f}")
    return results


def validate_kitti_tiled(model, multi_root="datasets/multi-kitti", iters=15,
                         nframes=4, patch_size=(432, 960), min_overlap=20,
                         sigma=0.05) -> Dict[str, float]:
    """Tiled high-res KITTI validation: overlapping train-size patches with
    Gaussian blending (reference validate_kitti_mf_tile,
    evaluate_mf.py:985-1053)."""
    fwd = graphed(model, iters)
    ds = mf_datasets.KITTIMultiFrameEval(multi_root=multi_root,
                                         split="training", nframes=nframes)
    epe_list, out_list = [], []
    for i in range(len(ds)):
        s = ds.load(i)
        flows = tiled_window_flows(fwd, s["images"], fwd.device, patch_size,
                                   min_overlap, sigma)
        epe, out = kitti_pair_metrics(flows, s, nframes)
        epe_list.append(epe)
        out_list.append(out)
    epe = float(np.mean(epe_list))
    f1 = float(100 * np.concatenate(out_list).mean())
    print(f"Validation KITTI (tiled): {epe:.4f}, {f1:.4f}")
    return {"kitti_tile_epe": epe, "kitti_tile_f1": f1}


def mine_worst_cases(model, root="datasets/sintel", iters=15, nframes=4,
                     dstypes=("clean", "final"), top_k=30,
                     save_root="worst_cases"):
    """Rank eval windows by mean EPE and dump the worst ones with input
    frames + predicted/GT flow visualizations (reference get_worst_case,
    evaluate_mf.py:172-248)."""
    from PIL import Image

    from streamflow_tpu_torch.data.flow_viz import flow_to_image

    fwd = graphed(model, iters)
    for dstype in dstypes:
        ds = mf_datasets.SintelMultiframeEval(split="training", dstype=dstype,
                                              root=root, nframes=nframes)

        def run(i):
            s = ds.load(i)
            return s, window_flows(fwd, s["images"], fwd.device)

        scores = []
        for i in range(len(ds)):
            s, flows = run(i)
            epes = [
                _epe_map(flows[p], s["flows"][p]).mean()
                for p in range(nframes - 1) if s["frame_ids"][p] != -1
            ]
            scores.append(float(np.mean(epes)) if epes else -1.0)

        worst = np.argsort(np.asarray(scores))[-top_k:][::-1]
        for rank, idx in enumerate(worst):
            s, flows = run(int(idx))
            out = os.path.join(save_root, dstype, f"{rank:02d}_{idx}")
            os.makedirs(out, exist_ok=True)
            for j in range(nframes):
                Image.fromarray(s["images"][j].astype(np.uint8)).save(
                    os.path.join(out, f"image{j}.png"))
            for p in range(nframes - 1):
                Image.fromarray(flow_to_image(flows[p])).save(
                    os.path.join(out, f"pred{p}.png"))
                Image.fromarray(flow_to_image(s["flows"][p])).save(
                    os.path.join(out, f"gt{p}.png"))
            with open(os.path.join(out, "epe.txt"), "w") as f:
                f.write(f"{scores[int(idx)]:.4f}\n")
        print(f"[{dstype}] worst-{top_k} windows written to {save_root}")


def validate_sintel_occlusion(model, root="datasets/sintel", iters=15,
                              nframes=4, dstype="final") -> Dict[str, float]:
    """Occluded / non-occluded EPE split (reference evaluate_mf.py:550-592)."""
    fwd = graphed(model, iters)
    ds = mf_datasets.SintelMultiframeEval(split="training", dstype=dstype,
                                          root=root, nframes=nframes,
                                          occ_map=True)
    epe_occ, epe_noc, epe_all_l = [], [], []
    for i in range(len(ds)):
        s = ds.load(i)
        flows = window_flows(fwd, s["images"], fwd.device)
        for p in range(nframes - 1):
            if s["frame_ids"][p] == -1:
                continue
            epe = _epe_map(flows[p], s["flows"][p])
            occ = s["occlusions"][p]
            epe_all_l.append(epe.reshape(-1))
            epe_occ.append(epe[occ].reshape(-1))
            epe_noc.append(epe[~occ].reshape(-1))
    res = {
        f"{dstype}_epe": float(np.concatenate(epe_all_l).mean()),
        f"{dstype}_epe_occ": float(np.concatenate(epe_occ).mean()),
        f"{dstype}_epe_noc": float(np.concatenate(epe_noc).mean()),
    }
    print(res)
    return res
