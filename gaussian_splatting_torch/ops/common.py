"""Shared constants of the tile rasterizer (counterpart of
``gaussian_splatting_tpu/ops/common.py``).

Per pixel, walking the tile's depth-sorted splats front to back:
  - alpha = opacity * exp(-0.5 * mh) if mh > 0 else 0, with +0.25 on the
    diagonal of the 2D covariance;
  - splats with alpha < ALPHA_SKIP are skipped;
  - a splat contributes alpha * T only while T >= T_EPS before it;
  - the background is blended with weight T only where T > BG_T_EPS.

``csrc/common.cuh`` holds the same values for the CUDA kernels.
"""

# skip threshold for faint splats (1/255)
ALPHA_SKIP = 0.00392156862
# forward early exit: a pixel stops once its transmittance T < T_EPS
T_EPS = 1e-4
# background blended only where T > BG_T_EPS
BG_T_EPS = 1e-3
# the backward clamps alpha at ALPHA_CLAMP before 1/(1 - alpha)
ALPHA_CLAMP = 0.9999

# rows of the per-gaussian DC feature matrix (N_FEAT, N):
#   u, v, opacity, a, b_half, c, r, g, b   (a/c carry the +0.25
#   regularisation, b_half = conic[1] / 2; rgb is pre-scaled by SH_0)
FEAT_U, FEAT_V, FEAT_OPACITY = 0, 1, 2
FEAT_A, FEAT_B, FEAT_C = 3, 4, 5
FEAT_R, FEAT_G, FEAT_B_COL = 6, 7, 8
N_FEAT = 9

# rows of the forward kernel's raw output (4, n_tiles * 256):
#   premultiplied r, g, b and final transmittance
OUT_R, OUT_G, OUT_B, OUT_T = 0, 1, 2, 3

PIXELS_PER_TILE = 256  # 16 x 16
