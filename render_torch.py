#!/usr/bin/env python
"""Render a trained scene with the PyTorch/CUDA port.

The port's twin of render.py: loads a JAX checkpoint (.npz) or a 3DGS .ply
and renders a circular orbit around the scene, optionally with depth maps.
On a CUDA device the rasterizer and the depth renderer run their
hand-written kernels.

    python render_torch.py runs/refscale7k/scene_final.ply --orbit 4 --depth
    python render_torch.py scene.ply --orbit 2 --device cpu --out renders/
"""

import argparse
import os
import struct
import zlib

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", help="ckpt .npz or 3DGS .ply")
    p.add_argument("--out", default="renders")
    p.add_argument("--dataset_path", default="",
                   help="dataset views need the dataio port (not yet); "
                   "use --orbit")
    p.add_argument("--orbit", type=int, default=0,
                   help="render N orbit views")
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


def write_png(path, img):
    """Write an (H, W) or (H, W, 3) uint8 array as an 8-bit PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    colour = 2 if img.ndim == 3 else 0  # truecolour or greyscale
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind, data):
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def load_scene(path, device):
    from gaussian_splatting_torch import checkpoint as ckpt

    if path.endswith(".ply"):
        return ckpt.import_ply(path, device=device)
    return ckpt.load_npz_scene(path, device=device)


def render_views(scene_path, *, out, orbit, width=1296, height=840,
                 focal=1100.0, sh_band=3, depth=False, alpha_threshold=0.5,
                 device):
    """Render ``orbit`` views of a scene file and write PNGs under ``out``.

    Returns one dict per view: name, image (H, W, 3) and depth (H, W) or
    None on ``device``, num_splats, num_visible and truncated.
    """
    import torch

    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.rasterize import rasterize, render_depth
    from gaussian_splatting_torch.structs import Camera

    if orbit <= 0:
        raise ValueError("render_views needs orbit > 0: dataset views wait "
                         "for the dataio port")
    cfg = SplatConfig()
    scene = load_scene(scene_path, device)
    params = {k: v.detach() for k, v in scene.params().items()}
    alive = scene.alive
    print(f"{scene_path}: {scene.num_alive()} gaussians on {device}")

    os.makedirs(out, exist_ok=True)
    xyz = params["xyz"][alive].cpu().numpy()
    K = torch.tensor([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    cam = Camera(K=K, width=width, height=height)
    background = torch.zeros(3, dtype=torch.float32, device=device)
    views = []
    with torch.no_grad():
        for j, pose in enumerate(orbit_poses(xyz, orbit)):
            name = f"orbit_{j:03d}"
            pose_t = torch.from_numpy(pose).to(device)
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


def main():
    parser = build_parser()
    args = parser.parse_args()
    if args.dataset_path:
        parser.error("--dataset_path needs the dataio port, which is not "
                     "done yet; render orbit views with --orbit N")
    if args.orbit <= 0:
        parser.error("give --orbit N (dataset views are not ported yet)")
    render_views(
        args.scene, out=args.out, orbit=args.orbit, width=args.width,
        height=args.height, focal=args.focal, sh_band=args.sh_band,
        depth=args.depth, alpha_threshold=args.alpha_threshold,
        device=args.device,
    )


if __name__ == "__main__":
    main()
