"""Point-cloud export and playback of DepthCrafter outputs.

Counterpart of ``worldforge_tpu/cli/visualize_pcd.py``, on the port's
``warp/pcd.py`` (host numpy: no device work). Reads
``<data-path>/<vid-name>.npz`` (``depth``: a disparity stack) and
``<vid-name>_input.mp4``, normalises the disparity over the whole clip and
unprojects every frame as DepthCrafter's ``visualization_pcd.py`` does. The
default backend writes one binary PLY a frame (MeshLab, CloudCompare,
Open3D); ``--backend viser`` serves the reference's interactive player
where viser is installed.

    python -m worldforge_tpu_torch.cli.visualize_pcd \
        --data-path demo_output --vid-name example_01 --out-dir pcd/
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from worldforge_tpu_torch.warp.pcd import (disparity_to_pointcloud,
                                     normalize_disparity, write_ply)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # the reference's flags (visualization_pcd.py)
    p.add_argument("--data-path", required=True,
                   help="dir holding <vid_name>.npz and <vid_name>_input.mp4")
    p.add_argument("--vid-name", required=True)
    p.add_argument("--downsample-factor", type=int, default=8)
    p.add_argument("--max-frames", type=int, default=100)
    p.add_argument("--point-size", type=float, default=0.007,
                   help="viser backend only")
    p.add_argument("--share", action="store_true", help="viser backend only")
    p.add_argument("--backend", choices=("ply", "viser"), default="ply")
    p.add_argument("--out-dir", default=None,
                   help="PLY output dir (default <data_path>/<vid_name>_pcd)")
    return p


def _load_video(path: str) -> np.ndarray:
    import cv2  # noqa: PLC0415
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise FileNotFoundError(f"no frames decoded from {path}")
    return np.stack(frames)


def load_clouds(data_path: str, vid_name: str, downsample_factor: int,
                max_frames: int):
    """Yields (points, colors) per frame, matching the reference's
    clip-global disparity normalization and H/W video crop (:32-44)."""
    disp = np.load(os.path.join(data_path, f"{vid_name}.npz"))["depth"]
    t, h, w = disp.shape
    disp = normalize_disparity(disp)
    vid = _load_video(os.path.join(data_path, f"{vid_name}_input.mp4"))
    vid = vid[:, :h, :w]
    n = min(max_frames, t, len(vid))
    if n < min(max_frames, t):
        print(f"warning: video decoded only {len(vid)} frames for "
              f"{t} depth frames; exporting the common prefix")
    for i in range(n):
        yield disparity_to_pointcloud(disp[i], vid[i], downsample_factor)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    clouds = list(load_clouds(args.data_path, args.vid_name,
                              args.downsample_factor, args.max_frames))
    if args.backend == "viser":
        _serve_viser(clouds, args)
        return
    out_dir = args.out_dir or os.path.join(args.data_path,
                                           f"{args.vid_name}_pcd")
    os.makedirs(out_dir, exist_ok=True)
    for i, (pts, cols) in enumerate(clouds):
        write_ply(os.path.join(out_dir, f"t{i:04d}.ply"), pts, cols)
    print(f"wrote {len(clouds)} PLY frames to {out_dir}")


def _serve_viser(clouds, args) -> None:  # pragma: no cover - needs viser
    """Reference playback UI (visualization_pcd.py:46-151), one visible
    frame node at a time, FPS slider play loop."""
    import time  # noqa: PLC0415

    import viser  # noqa: PLC0415

    server = viser.ViserServer()
    if args.share:
        server.request_share_url()
    nodes = []
    for i, (pts, cols) in enumerate(clouds):
        nodes.append(server.scene.add_frame(f"/frames/t{i}", show_axes=False))
        server.scene.add_point_cloud(f"/frames/t{i}/point_cloud",
                                     points=pts, colors=cols,
                                     point_size=args.point_size,
                                     point_shape="rounded")
    step = server.gui.add_slider("Timestep", min=0, max=len(nodes) - 1,
                                 step=1, initial_value=0)
    fps = server.gui.add_slider("FPS", min=1, max=60, step=0.1,
                                initial_value=16)
    playing = server.gui.add_checkbox("Playing", True)
    prev = 0

    @step.on_update
    def _(_):
        nonlocal prev
        with server.atomic():
            nodes[step.value].visible = True
            nodes[prev].visible = False
        prev = step.value

    for i, n in enumerate(nodes):
        n.visible = i == 0
    while True:
        if playing.value:
            step.value = (step.value + 1) % len(nodes)
        time.sleep(1.0 / fps.value)


if __name__ == "__main__":
    main()
