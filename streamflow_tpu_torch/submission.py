"""Leaderboard submission writers of the port (port of
streamflow_tpu/submission.py; reference evaluate_mf.py:252-322, 26-48,
804-853; submit_mf.py): Sintel .flo (+ color viz), the Sintel warm-start
variant via forward-interpolated low-res flow, KITTI 16-bit png, Spring
.flo5. The same file names, numbering and formats as the JAX package's;
every forward goes through ``evaluation.GraphedForward``.
"""

from __future__ import annotations

import os
import os.path as osp
import re

from streamflow_tpu_torch.data import frame_utils, mf_datasets
from streamflow_tpu_torch.data.flow_viz import flow_to_image
from streamflow_tpu_torch.evaluation import (GraphedForward,
                                             warm_window_flows, window_flows)


def create_sintel_submission(model, root="datasets/sintel",
                             output_path="sintel_submission", iters=20,
                             nframes=4, dstypes=("clean", "final"),
                             save_vis_flow=False):
    """Reference create_sintel_submission_mf (evaluate_mf.py:252-282)."""
    fwd = GraphedForward(model, iters)
    for dstype in dstypes:
        ds = mf_datasets.SintelMultiframeEval(split="test", dstype=dstype,
                                              root=root, nframes=nframes)
        for i in range(len(ds)):
            rec = ds.records[i]
            s = ds.load(i)
            flows = window_flows(fwd, s["images"], fwd.device)
            for p in range(nframes - 1):
                fid = int(s["frame_ids"][p])
                if fid == -1:
                    continue
                out_dir = osp.join(output_path, dstype, rec.scene)
                os.makedirs(out_dir, exist_ok=True)
                out = osp.join(out_dir, f"frame{fid + 1:04d}.flo")
                frame_utils.write_flo(out, flows[p])
                if save_vis_flow:
                    from PIL import Image

                    Image.fromarray(flow_to_image(flows[p])).save(
                        out.replace(".flo", ".png"))


def create_sintel_submission_warm(model, root="datasets/sintel",
                                  output_path="sintel_submission", iters=20,
                                  nframes=4, dstypes=("clean", "final"),
                                  ratio=8):
    """Warm-start variant (evaluate_mf.py:288-322): each window is initialized
    with the forward-interpolated low-res flows of the previous window."""
    fwd = GraphedForward(model, iters)
    for dstype in dstypes:
        ds = mf_datasets.SintelMultiframeEval(split="test", dstype=dstype,
                                              root=root, nframes=nframes)
        prev_scene, warm = None, None
        for i in range(len(ds)):
            rec = ds.records[i]
            s = ds.load(i)
            flows, warm = warm_window_flows(
                fwd, s["images"], fwd.device,
                warm if rec.scene == prev_scene else None, ratio)
            prev_scene = rec.scene
            for p in range(nframes - 1):
                fid = int(s["frame_ids"][p])
                if fid == -1:
                    continue
                out_dir = osp.join(output_path, dstype, rec.scene)
                os.makedirs(out_dir, exist_ok=True)
                frame_utils.write_flo(
                    osp.join(out_dir, f"frame{fid + 1:04d}.flo"), flows[p])


def create_kitti_submission(model, multi_root="datasets/multi-kitti",
                            output_path="kitti_submission", iters=20,
                            nframes=4):
    """Reference create_kitti_submission_mf (evaluate_mf.py:804-853):
    prediction for the 10->11 pair written as 16-bit png."""
    fwd = GraphedForward(model, iters)
    ds = mf_datasets.KITTIMultiFrameEval(multi_root=multi_root,
                                         split="testing", nframes=nframes)
    os.makedirs(output_path, exist_ok=True)
    for i in range(len(ds)):
        s = ds.load(i)
        flows = window_flows(fwd, s["images"], fwd.device, mode="kitti")
        frame_utils.write_flow_kitti(
            osp.join(output_path, ds.records[i].scene), flows[nframes - 2])


def create_spring_submission(model, root="datasets/spring",
                             output_path="spring_submission", iters=20,
                             nframes=4):
    """Reference create_spring_submission_mf (evaluate_mf.py:26-48): .flo5
    HDF5 files, one per pair of each direction and camera."""
    fwd = GraphedForward(model, iters)
    ds = mf_datasets.Spring(root=osp.join(root, "test"), nframes=nframes,
                            is_test=True)
    for i in range(len(ds)):
        rec = ds.records[i]
        s = ds.load(i)
        flows = window_flows(fwd, s["images"], fwd.device)
        scene, cam, tag = rec.scene.split("/")
        for p in range(nframes - 1):
            fid = int(s["frame_ids"][p])
            if fid == -1:
                continue
            out_dir = osp.join(output_path, scene, f"flow_{tag}_{cam}")
            os.makedirs(out_dir, exist_ok=True)
            # The .flo5 index is the 1-based frame number of the pair's FIRST
            # frame (reference numbering: FW j+1 / BW len-j,
            # core/mf_datasets.py:63,79; evaluate_mf.py:47): the number in
            # the pair's first image filename, in both directions.
            idx = int(re.findall(r"(\d+)", osp.basename(rec.images[p]))[-1])
            frame_utils.write_flo5(
                osp.join(out_dir, f"flow_{tag}_{cam}_{idx:04d}.flo5"),
                flows[p])
