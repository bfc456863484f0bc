"""Scaffold-GS (Lu et al., "Scaffold-GS: Structured 3D Gaussians for
View-Adaptive Rendering", CVPR 2024, arXiv:2312.00109) on the port's
render and training path.

A scene is ``capacity`` anchor slots with an ``alive`` mask.  An anchor
has a frozen position ``anchor`` (3), ``N_OFFSETS`` learnable offsets
``offset`` (10, 3), a feature ``anchor_feat`` (32) and a log-space
scaling ``scaling`` (6), and three MLPs, each ``Linear(35 -> 32), ReLU,
Linear(32 -> k)``, turn an anchor into ``N_OFFSETS`` neural gaussians for
each view: ``mlp_opacity`` (k = 10, then tanh), ``mlp_cov`` (k = 70, 7 a
gaussian) and ``mlp_color`` (k = 30, then sigmoid).  These are the
source's defaults: feat_dim 32, n_offsets 10, appearance_dim 0, no
distance inputs.

``decode`` gives one view's neural gaussians as the decoded rows that
``rasterize.kernel_inputs`` takes, and ``render`` renders them through
the shared layout and kernels B1/B2 (``rasterize.render_view``).  In a
view:

- the anchors decoded are the alive ones whose centres pass
  ``culling.frustum_visible_rows`` (the source prefilters with a
  rasterizer pass over the anchors' footprints instead).  They are
  compacted, which reads their count on the host once
  (``sync.decode.anchors``): the MLPs and the per-gaussian work then run
  over the anchors in view alone;
- each MLP reads ``[f_v, d_v]``, d_v the unit vector from the camera
  centre to the anchor;
- neural gaussian i of anchor v has position x_v + O_v,i * exp(l_v)[:3],
  scale exp(l_v)[3:] * sigmoid(cov_i[:3]) (carried as its log,
  l_v[3:] + logsigmoid(cov_i[:3])), rotation cov_i[3:7] (normalised on
  use, as a vanilla scene's quaternion), opacity from the tanh head and
  direct colour from the sigmoid head;
- only gaussians of opacity > 0 are rendered, as in the source, but they
  are not compacted: every candidate is a row, and one of opacity <= 0 is
  left out by the layout, whose opacity-aware window drops every gaussian
  of opacity <= 1/255 (as it drops those a compaction would keep), so it
  takes no gradient; the volume term's mean runs over the rows of opacity
  > 0.  The rows a step holds are then fixed by the anchors in view, which
  training does not move: compacted, their number swung by +-7% from step
  to step as the MLPs learned (the share of opacity > 0 follows a few
  weights), and the step's memory with it, for a saving of ~20 ms of
  glue over the half of the rows that do not render (PERF.md).

Leaves (``LEAVES``): ``offset``, ``anchor_feat``, ``scaling`` and each MLP
as one flat leaf (``pack_mlp``: its first weight, bias, second weight,
bias), six in all, which the fused Adam kernel takes in one launch.  The
anchor positions are no leaf: the source trains them at rate 0, which
leaves them where they are, so here they take no gradient and no Adam
state.  The MLPs' products run in float32, never TF32
(``exact_float32``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from gaussian_splatting_torch import geometry as geo
from gaussian_splatting_torch import rasterize, telemetry
from gaussian_splatting_torch.culling import frustum_visible_rows
from gaussian_splatting_torch.structs import Camera

FEAT_DIM = 32
N_OFFSETS = 10
HIDDEN = 32
IN_DIM = FEAT_DIM + 3  # the feature and the view direction
# each MLP's output width, and the activation of its output
HEADS = dict(mlp_opacity=N_OFFSETS, mlp_cov=7 * N_OFFSETS, mlp_color=3 * N_OFFSETS)
ACTIVATIONS = dict(mlp_opacity=torch.tanh, mlp_cov=None, mlp_color=torch.sigmoid)
_ACTIVATION_MODULES = dict(mlp_opacity=nn.Tanh, mlp_cov=nn.Identity, mlp_color=nn.Sigmoid)
ANCHOR_LEAVES = ("offset", "anchor_feat", "scaling")
LEAVES = ANCHOR_LEAVES + tuple(HEADS)
# the source's initial learning rates (its schedules are not run)
LEARNING_RATES = dict(offset=0.01, anchor_feat=0.0075, scaling=0.007,
                      mlp_opacity=0.002, mlp_cov=0.004, mlp_color=0.008)
VOLUME_WEIGHT = 0.01  # of the mean over rendered gaussians of the product of scales
ROW_WIDTH = 14  # xyz 3, log scale 3, quaternion 4, opacity 1, rgb 3


def pack_mlp(w1, b1, w2, b2) -> torch.Tensor:
    """An MLP's two ``Linear`` layers as one flat leaf."""
    return torch.cat([w1.reshape(-1), b1.reshape(-1), w2.reshape(-1), b2.reshape(-1)])


def unpack_mlp(flat, out: int) -> tuple:
    """(w1 (32, 35), b1 (32,), w2 (out, 32), b2 (out,)): views of a flat
    leaf; the gradients of all four reach it as one tensor."""
    w1, b1, w2, b2 = torch.split(flat, (HIDDEN * IN_DIM, HIDDEN, out * HIDDEN, out))
    return w1.view(HIDDEN, IN_DIM), b1, w2.view(out, HIDDEN), b2


@contextlib.contextmanager
def exact_float32():
    """Matrix products in float32 inside the block, TF32 off, whatever the
    process has set; restored after it.  A backward run inside the block
    is held to it too."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class ScaffoldScene(nn.Module):
    """The anchors of a Scaffold-GS scene, one per slot, and its MLPs.

    Fields (C = capacity):
      anchor      (C, 3)      frozen anchor positions (a buffer)
      offset      (C, 10, 3)  offsets, in units of exp(scaling)[:3]
      anchor_feat (C, 32)     features
      scaling     (C, 6)      log-space scalings: offsets' 3, then scales' 3
      alive       (C,)        bool buffer; dead slots are never decoded
      mlp_opacity, mlp_cov, mlp_color: ``nn.Sequential`` of two ``Linear``

    ``mlps`` maps an MLP's name to its (w1, b1, w2, b2); an MLP not given
    takes PyTorch's default ``Linear`` initialisation, drawn from the
    global generator."""

    def __init__(self, anchor, offset, anchor_feat, scaling, alive, mlps=None):
        super().__init__()
        cap, dev = anchor.shape[0], anchor.device
        want = dict(anchor=(cap, 3), offset=(cap, N_OFFSETS, 3), anchor_feat=(cap, FEAT_DIM),
                    scaling=(cap, 6), alive=(cap,))
        got = dict(anchor=anchor, offset=offset, anchor_feat=anchor_feat, scaling=scaling,
                   alive=alive)
        for k, shape in want.items():
            if tuple(got[k].shape) != shape:
                raise ValueError(f"{k} shape {tuple(got[k].shape)} != {shape}")
        self.register_buffer("anchor", anchor)
        self.offset = nn.Parameter(offset)
        self.anchor_feat = nn.Parameter(anchor_feat)
        self.scaling = nn.Parameter(scaling)
        self.register_buffer("alive", alive)
        for name, out in HEADS.items():
            mlp = nn.Sequential(nn.Linear(IN_DIM, HIDDEN, device=dev), nn.ReLU(),
                                nn.Linear(HIDDEN, out, device=dev), _ACTIVATION_MODULES[name]())
            if mlps is not None and name in mlps:
                w1, b1, w2, b2 = mlps[name]
                with torch.no_grad():
                    for p, v in zip((mlp[0].weight, mlp[0].bias, mlp[2].weight, mlp[2].bias),
                                    (w1, b1, w2, b2)):
                        p.copy_(v)
            setattr(self, name, mlp)

    def params(self) -> dict:
        """The six trainable leaves by name (``LEAVES``), each MLP packed."""
        out = {k: getattr(self, k) for k in ANCHOR_LEAVES}
        for name in HEADS:
            mlp = getattr(self, name)
            out[name] = pack_mlp(mlp[0].weight, mlp[0].bias, mlp[2].weight, mlp[2].bias)
        return out


def _mlp(params: dict, name: str, x):
    w1, b1, w2, b2 = unpack_mlp(params[name], HEADS[name])
    y = F.linear(torch.relu(F.linear(x, w1, b1)), w2, b2)
    act = ACTIVATIONS[name]
    return y if act is None else act(y)


class _TimeBackward(torch.autograd.Function):
    """The identity on a few tensors.  Its backward runs once the gradients
    of all of them are formed, and calls ``mark`` there: on the decoded
    rows, the decode's backward starts; on its leaves, it has ended."""

    @staticmethod
    def forward(ctx, mark, *xs):
        ctx.mark = mark
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.mark()
        return (None, *grads)


def decode(
    params: dict,
    anchor: torch.Tensor,
    alive: torch.Tensor,
    camera_T_world: torch.Tensor,
    camera: Camera,
    *,
    near_thresh: float,
    far_thresh: float,
    cull_mask_padding: float,
) -> dict:
    """One view's neural gaussians (module docstring) as ``rasterize.
    kernel_inputs`` takes decoded rows: ``xyz``, ``scale`` (log-space),
    ``quaternion``, ``rgb`` (N, 3/3/4/3) and ``opacity`` (N,) in (-1, 1),
    N = 10 an anchor in view, anchor by anchor; those of opacity <= 0 are
    not rendered.  Differentiable in the leaves of ``params``
    (``LEAVES``).  Counts ``anchors`` and ``neural`` (N), and, on a card
    while recording, the decode's device time forward and backward
    (``decode_us``)."""
    timer = telemetry.device_timer("decode_us", anchor.device)
    if timer is not None:
        if torch.is_grad_enabled():
            params = dict(params, **dict(zip(LEAVES, _TimeBackward.apply(
                timer.stop, *(params[k] for k in LEAVES)))))
        timer.start()
    with exact_float32():
        with torch.no_grad():
            a = anchor.T
            xc, yc, zc = geo.transform_rows(a[0], a[1], a[2], camera_T_world)
            u, v = geo.project_rows(xc, yc, zc, camera.K)
            seen = frustum_visible_rows(u, v, zc, (camera.width, camera.height),
                                        near_thresh, far_thresh, cull_mask_padding) & alive
        if timer is not None:  # the read's wait for the device is not the decode's work
            timer.stop()
        idx = torch.nonzero(seen).squeeze(1)
        if timer is not None:
            timer.start()
        telemetry.count("sync.decode.anchors")
        telemetry.count("anchors", idx.numel())
        x = anchor.index_select(0, idx)
        d = x - geo.camera_center_from_pose(camera_T_world)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        mlp_in = torch.cat([params["anchor_feat"].index_select(0, idx), d], dim=1)
        opacity = _mlp(params, "mlp_opacity", mlp_in)  # (V, 10)
        cov = _mlp(params, "mlp_cov", mlp_in).view(-1, N_OFFSETS, 7)
        colour = _mlp(params, "mlp_color", mlp_in).view(-1, N_OFFSETS, 3)
        scaling = params["scaling"].index_select(0, idx)
        step = torch.exp(scaling[:, None, :3])
        xyz = x[:, None, :] + params["offset"].index_select(0, idx) * step
        log_scale = scaling[:, None, 3:] + F.logsigmoid(cov[..., :3])
        rows = torch.cat([xyz, log_scale, cov[..., 3:], opacity[..., None], colour], dim=2)
        flat = rows.view(-1, ROW_WIDTH)
        telemetry.count("neural", flat.shape[0])
        out = (flat[:, 0:3], flat[:, 3:6], flat[:, 6:10], flat[:, 10], flat[:, 11:14])
    if timer is not None:
        if torch.is_grad_enabled():
            out = _TimeBackward.apply(timer.start, *out)
        timer.stop()
    return dict(zip(("xyz", "scale", "quaternion", "opacity", "rgb"), out))


def volume(rows: dict) -> torch.Tensor:
    """The source's volume regulariser: the mean over the rendered neural
    gaussians of the product of their three scales."""
    rendered = (rows["opacity"].detach() > 0.0).to(rows["scale"].dtype)
    # the product as the exponential of the log-scales' sum: prod's backward
    # reads on the host how many factors are zero, which no scale is
    return (torch.exp(rows["scale"].sum(dim=1)) * rendered).sum() / rendered.sum()


def render(
    params: dict,
    anchor: torch.Tensor,
    alive: torch.Tensor,
    camera_T_world: torch.Tensor,
    camera: Camera,
    *,
    near_thresh: float,
    far_thresh: float,
    cull_mask_padding: float,
    mh_dist: float,
    background_rgb: torch.Tensor,
):
    """One view of a Scaffold-GS scene: (``rasterize.RenderResult`` over the
    decoded rows, the rows).  The decode runs in the ``gs::render`` span, as
    the ``gs::render.decode`` span."""
    telemetry.count("views")
    with telemetry.span("gs::render"):
        with telemetry.span("gs::render.decode"):
            rows = decode(params, anchor, alive, camera_T_world, camera,
                          near_thresh=near_thresh, far_thresh=far_thresh,
                          cull_mask_padding=cull_mask_padding)
        res = rasterize.render_view(
            rows, None, camera_T_world, camera, near_thresh=near_thresh,
            far_thresh=far_thresh, cull_mask_padding=cull_mask_padding, mh_dist=mh_dist,
            background_rgb=background_rgb)
    return res, rows
