"""Training and rendering configuration (mirror of
``gaussian_splatting_tpu/config.py::SplatConfig``).

Same field names and defaults as the JAX config, so one config file serves
both packages.  The JAX package's ``__init__`` imports jax, so this mirror
is its own class; a test holds the two equal.  The fields of ``NOT_READ``
size the JAX package's static buffers, TPU kernels and dispatch; the port
has no capacities and reads none of them.

``to_yaml``/``from_yaml`` write and read the flat YAML of the JAX package's
``config.yaml`` (what ``yaml.safe_dump`` gives this dataclass: ints,
floats, bools, strings, null and lists of ints) without PyYAML, which the
port does not depend on.  ``preset`` and ``FIELD_HELP`` are the JAX
package's, for the CLI, apart from the help of the ``NOT_READ`` fields.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
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

    def __post_init__(self):
        # yaml reads tier_capacities as a list; the config stays hashable
        if isinstance(self.tier_capacities, list):
            object.__setattr__(self, "tier_capacities", tuple(self.tier_capacities))

    def replace(self, **kw) -> "SplatConfig":
        return dataclasses.replace(self, **kw)

    def to_yaml(self) -> str:
        """The config as the flat YAML mapping that the JAX package's
        ``to_yaml`` (``yaml.safe_dump``, fields in order) writes."""
        lines = []
        for k, v in dataclasses.asdict(self).items():
            if isinstance(v, (tuple, list)) and not v:
                lines.append(f"{k}: []")
            elif isinstance(v, (tuple, list)):
                lines.append(f"{k}:")
                lines += [f"- {_yaml_scalar(x)}" for x in v]
            else:
                lines.append(f"{k}: {_yaml_scalar(v)}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def from_yaml(text: str) -> "SplatConfig":
        return SplatConfig(**_parse_flat_yaml(text))


# PyYAML's implicit resolvers (YAML 1.1) for the plain scalars a flat
# mapping holds; a plain scalar that matches none of them is a string
_YAML_NULL = re.compile(r"~|null|Null|NULL|")
_YAML_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF")
_YAML_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
# YAML 1.1 dates and a few indicators PyYAML resolves as non-strings
_YAML_OTHER = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=")
# strings written plain: a letter, '_', '/' or '.' first, then path characters
_YAML_PLAIN_STR = re.compile(r"[A-Za-z_/.][A-Za-z0-9_./-]*")
_YAML_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
                 "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
                 " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
                 "_": "\xa0", "L": "\u2028", "P": "\u2029"}


def _yaml_scalar(v) -> str:
    """One value as PyYAML's safe_dump writes it, on one line."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        # PyYAML's float form: "1e-08" would read back as a string
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e")
        return text
    if not isinstance(v, str):
        raise TypeError(f"no YAML form for {type(v).__name__} {v!r}")
    if _YAML_PLAIN_STR.fullmatch(v) and isinstance(_resolve_plain(v), str):
        return v
    if v.isascii() and v.isprintable():
        return "'" + v.replace("'", "''") + "'"
    # a JSON string is a YAML double-quoted scalar
    return json.dumps(v)


def _resolve_plain(s: str):
    """A plain scalar's value, by PyYAML's implicit resolvers."""
    if _YAML_NULL.fullmatch(s):
        return None
    if _YAML_BOOL.fullmatch(s):
        return s.lower() in ("yes", "true", "on")
    if _YAML_INT.fullmatch(s) or _YAML_FLOAT.fullmatch(s) or _YAML_OTHER.fullmatch(s):
        t = s.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        body = t.lstrip("+-")
        if ":" in body or _YAML_OTHER.fullmatch(s):
            raise ValueError(f"unsupported YAML scalar {s!r}")
        if _YAML_FLOAT.fullmatch(s):
            if body.lower() in (".inf", ".nan"):
                return sign * math.inf if body.lower() == ".inf" else math.nan
            return float(t)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    return s


def _fold(lines: list) -> str:
    """The flow-scalar folding of a value's source lines: one line break
    becomes a space, each empty line a newline."""
    if len(lines) == 1:
        return lines[0]
    out, breaks = lines[0].rstrip(" \t"), 0
    for j, ln in enumerate(lines[1:], start=2):
        s = ln.lstrip(" \t") if j == len(lines) else ln.strip(" \t")
        if not s and j < len(lines):
            breaks += 1
            continue
        out += "\n" * breaks if breaks else " "
        breaks = 0
        out += s
    return out


def _unquote(text: str):
    """A quoted scalar's value, and the text left after its closing quote;
    None while the closing quote has not been read."""
    q = text[0]
    i = 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            body = text[1:i].split("\n")
            return _fold(body).replace("''", "'"), text[i + 1:]
        if q == '"' and c == "\\":
            i += 2
            continue
        if q == '"' and c == '"':
            return _unescape_double(text[1:i]), text[i + 1:]
        i += 1
    return None


def _unescape_double(body: str) -> str:
    out, i = [], 0
    # an escaped line break joins its lines with nothing between them
    folded = "".join(_fold(part.split("\n"))
                     for part in re.split(r"\\\n[ \t]*", body))
    while i < len(folded):
        c = folded[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = folded[i + 1]
        width = {"x": 2, "u": 4, "U": 8}.get(e)
        if width:
            out.append(chr(int(folded[i + 2:i + 2 + width], 16)))
            i += 2 + width
        elif e in _YAML_ESCAPES:
            out.append(_YAML_ESCAPES[e])
            i += 2
        else:
            raise ValueError(f"unknown YAML escape \\{e}")
    return "".join(out)


def _scalar_value(text: str):
    text = text.strip()
    if text[:1] in ("'", '"'):
        got = _unquote(text)
        if got is None or got[1].strip():
            raise ValueError(f"bad quoted YAML scalar {text!r}")
        return got[0]
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar_value(x) for x in inner.split(",")] if inner else []
    return _resolve_plain(text)


def _parse_flat_yaml(text: str) -> dict:
    """The mapping of a flat YAML document: one ``key: value`` per field,
    values scalars (plain or quoted, possibly folded over several lines)
    or lists of scalars, in block ("- x" lines) or flow ("[x, y]") form.
    Comments and a leading "---" are skipped."""
    lines = text.splitlines()
    out, i = {}, 0
    while i < len(lines):
        ln = lines[i]
        i += 1
        if not ln.strip() or ln.lstrip().startswith("#") or ln.strip() == "---":
            continue
        if ln[0] in " \t-":
            raise ValueError(f"unexpected YAML line {ln!r}")
        key, sep, rest = ln.partition(":")
        if not sep:
            raise ValueError(f"not a 'key: value' line: {ln!r}")
        rest = rest.strip()
        if rest[:1] in ("'", '"'):
            # a quoted value runs on until its closing quote
            while _unquote(rest) is None and i < len(lines):
                rest += "\n" + lines[i]
                i += 1
            out[key.strip()] = _scalar_value(rest)
            continue
        if rest.startswith("#"):
            rest = ""
        rest = rest.split(" #")[0].strip()
        cont = []
        while i < len(lines) and lines[i][:1] in (" ", "\t") and lines[i].strip():
            cont.append(lines[i])
            i += 1
        if rest:
            out[key.strip()] = _scalar_value(_fold([rest] + cont) if cont else rest)
            continue
        items = []
        while i < len(lines) and lines[i].startswith("-"):
            items.append(_scalar_value(lines[i][1:].split(" #")[0]))
            i += 1
        out[key.strip()] = items if items else None
    return out


# the JAX package's TPU capacity, kernel and dispatch fields, which the port
# accepts (one config file serves both packages) and does not read
NOT_READ = ("splat_capacity", "max_splat_capacity", "visible_capacity",
            "tier_capacities", "chunk", "kernel_precision", "overflow_updates",
            "steps_per_dispatch")

# one-line help per field, rendered by train_torch.py: the JAX package's
# text, so both CLIs document a flag alike, apart from the NOT_READ fields,
# whose help says that the port does not read them
FIELD_HELP = {
    "dataset_path": "COLMAP dataset directory (sparse/0 + images)",
    "downsample_factor": "image downsample factor (1, 2, 4, 8)",
    "output_dir": "directory for config.yaml, checkpoints, debug images",
    "checkpoint_interval": "save a checkpoint every N iterations",
    "load_checkpoint": "resume from checkpoint_path instead of initialising",
    "checkpoint_path": "checkpoint .npz to resume from",
    "load_ply": "initialise from a 3DGS .ply (viewer/community layout)",
    "save_debug_image_interval": "save a render of train view 0 every N "
    "iterations (0 disables)",
    "print_interval": "print train PSNR/size every N iterations",
    "initial_opacity": "initial opacity of every gaussian",
    "initial_scale_num_neighbors": "K for the KNN that sets initial scales",
    "initial_scale_factor": "initial scale = factor * mean KNN distance",
    "max_initial_scale": "upper clamp on the initial scale",
    "near_thresh": "cull gaussians closer than this camera-space depth",
    "far_thresh": "cull gaussians farther than this camera-space depth",
    "mh_dist": "Mahalanobis distance defining a splat's tile footprint",
    "cull_mask_padding": "pixels outside the image still considered visible",
    "saturated_pixel_value": "white level used to normalise images",
    "num_iters": "total training iterations",
    "ssim_frac": "loss = (1-frac)*L1 + frac*(1-SSIM)",
    "base_lr": "Adam base learning rate",
    "xyz_lr_multiplier": "xyz lr = base_lr * this",
    "quat_lr_multiplier": "quaternion lr = base_lr * this",
    "scale_lr_multiplier": "scale lr = base_lr * this",
    "opacity_lr_multiplier": "opacity lr = base_lr * this",
    "rgb_lr_multiplier": "rgb (SH DC) lr = base_lr * this",
    "sh_lr_multiplier": "higher SH band lr = base_lr * this",
    "test_eval_interval": "evaluate the test split every N iterations",
    "test_split_ratio": "every Nth image is held out for test",
    "use_background": "cycle the background colour during early training",
    "use_background_end": "stop the background cycle at this iteration",
    "reset_opacity_interval": "reset opacities every N iterations",
    "reset_opacity_value": "opacity value applied by a reset",
    "reset_opacity_start": "first iteration a reset may fire",
    "reset_opacity_end": "last iteration a reset may fire",
    "use_sh_precompute": "evaluate SH once per gaussian per view (vs "
    "per-pixel ray directions in the kernel)",
    "max_sh_band": "highest spherical-harmonics band (0-3)",
    "add_sh_band_interval": "unlock one more SH band every N iterations",
    "use_split": "ADC: split large high-gradient gaussians",
    "use_clone": "ADC: clone small high-gradient gaussians",
    "use_delete": "ADC: delete transparent/stale gaussians",
    "adaptive_control_start": "first iteration ADC may fire",
    "adaptive_control_end": "last iteration ADC may fire",
    "adaptive_control_interval": "run ADC every N iterations",
    "max_gaussians": "stop densifying above this many alive gaussians",
    "delete_opacity_threshold": "delete gaussians below this opacity",
    "clone_scale_threshold": "clone below this max scale, split above",
    "max_scale_norm": "upper clamp on scale norms (reference parity knob)",
    "use_fractional_densification": "percentile-based densify thresholds "
    "instead of a fixed uv-grad threshold",
    "use_adaptive_fractional_densification": "anneal the densify "
    "percentiles toward the end of ADC",
    "uv_grad_percentile": "uv-gradient percentile that triggers densify",
    "scale_norm_percentile": "scale percentile that triggers split",
    "uv_grad_threshold": "fixed uv-grad densify threshold (non-fractional)",
    "split_scale_factor": "each split sample shrinks scale by this factor",
    "num_split_samples": "samples per split (fixed-capacity impl: 2)",
    "gaussian_capacity": "gaussian slot capacity; <=0 derives it from the "
    "initial point count (8x headroom, capped by max_gaussians)",
    "splat_capacity": "JAX package only (the TPU splat-list capacity); the "
    "port has no capacities and does not read it",
    "max_splat_capacity": "JAX package only (the ceiling of the TPU "
    "splat-capacity growth); not read by the port",
    "visible_capacity": "JAX package only (the TPU visible-gaussian "
    "compaction capacity); not read by the port",
    "tier_capacities": "JAX package only (the TPU per-tier member "
    "capacities, comma-separated); not read by the port",
    "chunk": "JAX package only (splats per TPU grid step); the port's "
    "kernels walk a tile's splats in batches of their own and do not read it",
    "kernel_precision": "JAX package only ('bf16' packs the TPU sort's "
    "operands); the port sorts exact int64 keys and does not read it",
    "overflow_updates": "JAX package only (updates on TPU capacity-overflow "
    "frames); the port has no capacities and does not read it",
    "synthetic_points": "synthetic preset: secret-scene (gt) point count",
    "synthetic_images": "synthetic preset: number of ring views",
    "synthetic_init_points": "synthetic preset: train-init point count "
    "(0 = all synthetic points; a sparse init forces ADC growth)",
    "synthetic_width": "synthetic preset: image width",
    "synthetic_height": "synthetic preset: image height",
    "seed": "random seed",
    "data_parallel": "data-parallel devices (cameras per step); 1 = "
    "reference semantics",
    "model_parallel": "gaussian-sharded devices (scene + image bands "
    "sharded over the mesh); 1 = single-device",
    "steps_per_dispatch": "JAX package only (lax.scan steps per TPU "
    "dispatch); the port dispatches every step and does not read it",
    "profile_start": "first iteration of the device-trace window",
    "profile_steps": "device-trace window length (0 = no profiling)",
}


def preset(name: str) -> SplatConfig:
    """`7k` / `30k` presets (reference: splat_py/config.py:161-173)."""
    if name == "7k":
        return SplatConfig()
    if name == "30k":
        return SplatConfig(
            num_iters=30000,
            adaptive_control_start=1500,
            adaptive_control_end=27500,
            adaptive_control_interval=300,
            reset_opacity_end=27500,
            use_background_end=28000,
        )
    raise ValueError(f"unknown preset {name!r} (expected '7k' or '30k')")
