"""Training and rendering configuration (mirror of
``gaussian_splatting_tpu/config.py::SplatConfig``).

Same field names and defaults as the JAX config, so one config file serves
both packages.  The JAX package's ``__init__`` imports jax, so this mirror
is its own class; a test holds the two equal.  The fields under
"TPU-specific" size the JAX package's static buffers, kernels and dispatch;
the port has no capacities and reads none of them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SplatConfig:
    # --- dataset / io -----------------------------------------------------
    dataset_path: str = "garden"
    downsample_factor: int = 4
    output_dir: str = "splat_output"
    checkpoint_interval: int = 10000
    load_checkpoint: bool = False
    checkpoint_path: str = ""
    load_ply: str = ""
    save_debug_image_interval: int = 200
    print_interval: int = 100

    # --- initialisation ---------------------------------------------------
    initial_opacity: float = 0.2
    initial_scale_num_neighbors: int = 3
    initial_scale_factor: float = 0.8
    max_initial_scale: float = 0.1

    # --- culling ----------------------------------------------------------
    near_thresh: float = 0.3
    far_thresh: float = 500.0
    mh_dist: float = 3.0
    cull_mask_padding: int = 100
    saturated_pixel_value: float = 255.0

    # --- optimisation -----------------------------------------------------
    num_iters: int = 7000
    ssim_frac: float = 0.2
    base_lr: float = 0.002
    xyz_lr_multiplier: float = 0.1
    quat_lr_multiplier: float = 2.0
    scale_lr_multiplier: float = 5.0
    opacity_lr_multiplier: float = 10.0
    rgb_lr_multiplier: float = 2.0
    sh_lr_multiplier: float = 0.1

    # --- evaluation -------------------------------------------------------
    test_eval_interval: int = 500
    test_split_ratio: int = 8

    # --- background schedule ----------------------------------------------
    use_background: bool = True
    use_background_end: int = 6600

    # --- opacity reset schedule --------------------------------------------
    reset_opacity_interval: int = 3001
    reset_opacity_value: float = 0.20
    reset_opacity_start: int = 1050
    reset_opacity_end: int = 6500

    # --- spherical harmonics ------------------------------------------------
    use_sh_precompute: bool = True
    max_sh_band: int = 3
    add_sh_band_interval: int = 1000

    # --- adaptive density control -------------------------------------------
    use_split: bool = True
    use_clone: bool = True
    use_delete: bool = True
    adaptive_control_start: int = 750
    adaptive_control_end: int = 6500
    adaptive_control_interval: int = 100
    max_gaussians: int = 4250000
    delete_opacity_threshold: float = 0.1
    clone_scale_threshold: float = 0.01
    max_scale_norm: float = 0.5
    use_fractional_densification: bool = True
    use_adaptive_fractional_densification: bool = True
    uv_grad_percentile: float = 0.96
    scale_norm_percentile: float = 0.99
    uv_grad_threshold: float = 0.0002
    split_scale_factor: float = 1.6
    num_split_samples: int = 2

    # --- TPU-specific (read by the JAX package only) -------------------------
    gaussian_capacity: int = 0
    splat_capacity: int = 1 << 23
    max_splat_capacity: int = 1 << 24
    visible_capacity: int = 0
    tier_capacities: tuple | None = None
    chunk: int = 256
    kernel_precision: str = "bf16"
    overflow_updates: bool = False
    # --- synthetic benchmark scene -------------------------------------------
    synthetic_points: int = 20000
    synthetic_images: int = 48
    synthetic_init_points: int = 0
    synthetic_width: int = 640
    synthetic_height: int = 480
    seed: int = 0
    data_parallel: int = 1
    model_parallel: int = 1
    steps_per_dispatch: int = 1
    profile_start: int = 20
    profile_steps: int = 0

    def replace(self, **kw) -> "SplatConfig":
        return dataclasses.replace(self, **kw)
