#!/usr/bin/env python
"""Render a trained scene with the PyTorch/CUDA port.

The port's twin of render.py: loads a checkpoint (.npz, of either package)
or a 3DGS .ply and renders the views of a COLMAP dataset or a circular
orbit around the scene, optionally with depth maps.  On a CUDA device the
rasterizer and the depth renderer run their hand-written kernels.

    python render_torch.py runs/refscale7k/scene_final.ply --orbit 4 --depth
    python render_torch.py scene.ply --orbit 2 --device cpu --out renders/
    python render_torch.py ckpt_final.npz --dataset_path garden \
        --downsample_factor 4 --out renders/ --depth
"""

import argparse
import os

import numpy as np

from gaussian_splatting_torch.dataio.png import write_png


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", help="ckpt .npz or 3DGS .ply")
    p.add_argument("--out", default="renders")
    p.add_argument("--dataset_path", default="",
                   help="COLMAP dataset whose views to render")
    p.add_argument("--downsample_factor", type=int, default=4)
    p.add_argument("--orbit", type=int, default=0,
                   help="render N orbit views instead of dataset views")
    p.add_argument("--width", type=int, default=1296)
    p.add_argument("--height", type=int, default=840)
    p.add_argument("--focal", type=float, default=1100.0)
    p.add_argument("--sh_band", type=int, default=3)
    p.add_argument("--depth", action="store_true",
                   help="also save depth maps (-1 = no surface)")
    p.add_argument("--alpha_threshold", type=float, default=0.5,
                   help="accumulated-alpha crossing that defines the depth "
                   "surface")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda runs the kernels)")
    return p


def orbit_poses(xyz, n, height_frac=0.15):
    """n cameras on a circle around the scene centroid, looking at it."""
    c = xyz.mean(0)
    r = float(np.quantile(np.linalg.norm(xyz - c, axis=1), 0.95)) * 2.2
    poses = []
    for t in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = c + r * np.array(
            [np.sin(t), -height_frac, np.cos(t)], np.float32
        )
        fwd = c - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0, -1.0, 0], np.float32))
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        R = np.stack([right, up, fwd])  # world -> camera rows
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = -R @ eye
        poses.append(T)
    return poses


def load_scene(path, device):
    from gaussian_splatting_torch import checkpoint as ckpt

    if path.endswith(".ply"):
        return ckpt.import_ply(path, device=device)
    return ckpt.load_npz_scene(path, device=device)


def render_views(scene_path, *, out, orbit=0, dataset_path="", downsample_factor=4,
                 width=1296, height=840, focal=1100.0, sh_band=3, depth=False,
                 alpha_threshold=0.5, device):
    """Render a scene file from ``orbit`` orbit views (width x height at
    ``focal``), or else from every view of the COLMAP dataset at
    ``dataset_path``, and write PNGs under ``out``.

    Returns one dict per view: name, image (H, W, 3) and depth (H, W) or
    None on ``device``, num_splats, num_visible and truncated.
    """
    import torch

    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.rasterize import rasterize, render_depth
    from gaussian_splatting_torch.structs import Camera

    cfg = SplatConfig()
    scene = load_scene(scene_path, device)
    params = {k: v.detach() for k, v in scene.params().items()}
    alive = scene.alive
    print(f"{scene_path}: {scene.num_alive()} gaussians on {device}")

    # (name, K, camera_T_world, width, height) of each view
    if orbit > 0:
        xyz = params["xyz"][alive].cpu().numpy()
        K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
                     np.float32)
        cams = [(f"orbit_{j:03d}", K, pose, width, height)
                for j, pose in enumerate(orbit_poses(xyz, orbit))]
    elif dataset_path:
        from gaussian_splatting_torch.dataio.dataset import ColmapDataset

        data = ColmapDataset(dataset_path, downsample_factor).scene_data()
        cams = []
        for j, im in enumerate(data.images):
            c = data.cameras[im.camera_id]
            cams.append((f"view_{j:03d}", c.K, im.camera_T_world, c.width, c.height))
    else:
        raise ValueError("render_views needs orbit > 0 or a dataset_path")

    os.makedirs(out, exist_ok=True)
    background = torch.zeros(3, dtype=torch.float32, device=device)
    views = []
    with torch.no_grad():
        for name, K, pose, width, height in cams:
            cam = Camera(K=torch.tensor(K, dtype=torch.float32, device=device),
                         width=width, height=height)
            pose_t = torch.tensor(pose, dtype=torch.float32, device=device)
            res = rasterize(
                params, alive, pose_t, cam,
                near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                cull_mask_padding=cfg.cull_mask_padding, mh_dist=cfg.mh_dist,
                background_rgb=background, n_sh_band=sh_band,
            )
            d = None
            if depth:
                d = render_depth(
                    params, alive, pose_t, cam,
                    alpha_threshold=alpha_threshold,
                    near_thresh=cfg.near_thresh,
                    cull_mask_padding=cfg.cull_mask_padding,
                    mh_dist=cfg.mh_dist,
                )[..., 0]
            img = (res.image.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
            write_png(os.path.join(out, f"{name}.png"), img)
            if d is not None:
                dn = d.cpu().numpy()
                vmax = max(float(dn.max()), 1e-6)
                dimg = np.where(dn < 0, 0, dn / vmax)
                write_png(os.path.join(out, f"{name}_depth.png"),
                          (dimg * 255).astype(np.uint8))
            print(f"  wrote {name} ({width}x{height}, {res.num_splats} splats, "
                  f"{res.num_visible} visible, {res.truncated} truncated cells)")
            views.append(dict(
                name=name, image=res.image, depth=d,
                num_splats=res.num_splats, num_visible=res.num_visible,
                truncated=res.truncated,
            ))
    return views


def main(argv=None):
    """Parse ``argv`` (the command line when None), render, and return
    ``render_views``' list of views."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.orbit <= 0 and not args.dataset_path:
        parser.error("give --orbit N or --dataset_path DIR")
    return render_views(
        args.scene, out=args.out, orbit=args.orbit, dataset_path=args.dataset_path,
        downsample_factor=args.downsample_factor, width=args.width,
        height=args.height, focal=args.focal, sh_band=args.sh_band,
        depth=args.depth, alpha_threshold=args.alpha_threshold,
        device=args.device,
    )


if __name__ == "__main__":
    main()
