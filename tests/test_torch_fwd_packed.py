"""The algebra of the forward kernels B1 and B3 (``csrc/render_fwd.cu``,
``csrc/render_sh_fwd.cu``) on their packed records, on the CPU.

The pack (``pack_fwd_rows_plain``, which the kernel ``gs_pack_fwd_rows``
matches bitwise on the card) turns the (rows, N) feature matrix into
gaussian-major records u, v, op, a, b, c, rdet, rows 6.., zero-padded to a
multiple of 4 floats.  A test-local plain torch model of the kernels' walk
reads only those records: one 16x16 tile at a time, 128 threads of two
vertically adjacent pixels each, batches of the kernels' size (and of 2,
so that tile lengths are not multiples of the batch), the stop at T < T_EPS
per pixel and per block, and B3's colour contracted in the
kernel's fused multiply-add order.  It is held against ``render_fwd_plain``
and ``render_sh_fwd_plain`` at 1e-5 on the 6-gaussian fixture and on a
seeded scene, at n_sh 4, 9 and 16, with the tiles taken heaviest first
(``tile_order_plain``, a permutation that leaves the image as it was).  The
kernels' C launchers are held to ``_build.SIGNATURES``.
"""

import re

import pytest
import torch

from gaussian_splatting_torch import _build
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.ops import depth as tdepth
from gaussian_splatting_torch.ops import render as trender
from gaussian_splatting_torch.ops import render_sh as trsh
from gaussian_splatting_torch.structs import TILE_PX
from tests.test_torch_bwd_staged import _dc_inputs, _sh_inputs
from tests.test_torch_probes import _c_params

# the model and the plain versions composite in the same order; they differ
# by exp's rounding, the fused multiply-adds of B3's contraction and T's
# product (sequential against cumprod)
MODEL_TOL = 1e-5
THREADS = cc.PIXELS_PER_TILE // 2
SMALL_BATCH = 2  # under the fixture's longest tile list (3 splats)


def _kernel_batch(source):
    """The kBatch of a kernel source: the model walks the kernel's batches."""
    text = (_build.SRC_DIR / source).read_text()
    return int(re.search(r"constexpr int kBatch = (\d+);", text).group(1))


def _fma(a, b, c):
    """float32 fmaf(a, b, c): the product is exact in float64, so one
    rounding of the float64 sum to float32 stands for the kernel's single
    rounding (the two differ only where the float64 sum lies on a float32
    rounding boundary)."""
    return (a.double() * b.double() + c.double()).float()


def _thread_pixels():
    """(128, 2) tile pixel index of each thread's two pixels: column t % 16,
    rows 2 (t // 16) and 2 (t // 16) + 1."""
    t = torch.arange(THREADS)
    row0 = 2 * (t // TILE_PX)
    col = t % TILE_PX
    return torch.stack([row0 * TILE_PX + col, (row0 + 1) * TILE_PX + col], dim=1)


def packed_walk(rec, gaussian_idx, tile_starts, x_tiles, batch, colour, order=None):
    """The kernels' walk over packed records: (4, n_tiles * 256) rows
    premultiplied r, g, b and T.  ``colour(sj, tile, pix)`` gives the staged
    record sj's colour at the threads' pixels pix (128, 2) of the tile,
    (3, 128, 2).  The blocks take the tiles in ``order`` (default: in index
    order)."""
    n_tiles = tile_starts.numel() - 1
    half = (TILE_PX - 1) / 2
    pix = _thread_pixels()
    up = (pix % TILE_PX).float() - half
    vp = (pix // TILE_PX).float() - half
    out = torch.zeros(4, n_tiles * cc.PIXELS_PER_TILE)
    starts = tile_starts.tolist()
    for tile in (range(n_tiles) if order is None else order.tolist()):
        ox, oy = float((tile % x_tiles) * TILE_PX), float((tile // x_tiles) * TILE_PX)
        T = torch.ones(THREADS, 2)
        acc = torch.zeros(3, THREADS, 2)
        lo, hi = starts[tile], starts[tile + 1]
        for base in range(lo, hi, batch):
            # the batch's records, u and v made tile-local as they are staged
            st = rec[gaussian_idx[base:min(base + batch, hi)].long()].clone()
            st[:, 0] = (st[:, 0] - ox) - half
            st[:, 1] = (st[:, 1] - oy) - half
            for sj in st:
                ul, vl, op, a, b, c, rdet = sj[:trender.REC_RDET + 1]
                du, dv = up - ul, vp - vl
                mh = (c * du * du - 2.0 * b * du * dv + a * dv * dv) * rdet
                alpha = op * torch.where(mh > 0.0, torch.exp(-0.5 * mh), torch.zeros_like(mh))
                # a pixel takes no splat once T < T_EPS
                hit = (T >= cc.T_EPS) & (alpha >= cc.ALPHA_SKIP)
                if not bool(hit.any()):
                    continue
                w = alpha * T
                acc = torch.where(hit, acc + colour(sj, tile, pix) * w, acc)
                T = torch.where(hit, T * (1.0 - alpha), T)
            # the block leaves once every pixel has stopped
            if not bool((T >= cc.T_EPS).any()):
                break
        o = tile * cc.PIXELS_PER_TILE + pix
        out[0:3, o] = acc
        out[3, o] = T
    return out


def dc_colour(sj, tile, pix):
    """B1: the record's r, g, b (pre-scaled by SH_0) at every pixel."""
    return sj[trender.REC_RDET + 1:trender.REC_RDET + 4][:, None, None].expand(3, *pix.shape)


def sh_colour(basis):
    """B3: sum_k coeff[c * n_sh + k] * basis[k] at each pixel, the first term
    a product and the rest fused multiply-adds in order of k."""
    n_sh = basis.shape[0]
    bt = basis.reshape(n_sh, -1, cc.PIXELS_PER_TILE)

    def colour(sj, tile, pix):
        coeff = sj[trender.REC_RDET + 1:trender.REC_RDET + 1 + 3 * n_sh]
        b = bt[:, tile][:, pix]  # (n_sh, 128, 2)
        cols = []
        for ch in range(3):
            col = coeff[ch * n_sh] * b[0]
            for k in range(1, n_sh):
                col = _fma(coeff[ch * n_sh + k].expand_as(col), b[k], col)
            cols.append(col)
        return torch.stack(cols)
    return colour


def _assert_matches(got, want):
    img_err = float((got[0:3] - want[0:3]).abs().max())
    t_mask = want[3] >= cc.T_EPS
    t_err = float((got[3] - want[3]).abs()[t_mask].max())
    assert img_err <= MODEL_TOL and t_err <= MODEL_TOL, (img_err, t_err)
    assert float(want[0:3].abs().max()) > 0.05  # the inputs composite something


def _check_batches(layout, batch):
    """Some tile's list is not a multiple of the batch, and with the small
    batch some tile needs more than one."""
    counts = layout.tile_counts[layout.tile_counts > 0]
    assert bool((counts % batch != 0).any()), counts
    if batch == SMALL_BATCH:
        assert int(counts.max()) > batch, counts


@pytest.mark.parametrize("rows", [cc.N_FEAT] + [trsh.sh_feat_rows(n) for n in trsh.KERNEL_N_SH]
                         + [tdepth.N_DEPTH_FEAT])
def test_pack_layout_and_rdet(rows):
    """Records u, v, op, a, b, c, rdet, rows 6.., zero-padded to a multiple
    of 4 (12 floats for B1; 20, 36, 56 for B3 at n_sh 4, 9, 16; 8 for B5,
    whose distance is float 7, with no padding); rdet bitwise the walk's own
    (``_splat_chunk``, the kernels' ``load_geom``)."""
    n = 37
    gen = torch.Generator().manual_seed(rows)
    feat = torch.randn(rows, n, generator=gen)
    feat[cc.FEAT_A] = feat[cc.FEAT_A].abs() + 0.25
    feat[cc.FEAT_C] = feat[cc.FEAT_C].abs() + 0.25
    rec = trender.pack_fwd_rows_plain(feat)
    stride = trender.packed_stride(rows)
    assert stride % 4 == 0 and rows + 1 <= stride < rows + 5
    assert tuple(rec.shape) == (n, stride) and rec.dtype == torch.float32
    assert torch.equal(rec[:, :trender.REC_RDET], feat[:trender.REC_RDET].T)
    assert torch.equal(rec[:, trender.REC_RDET + 1:rows + 1], feat[trender.REC_RDET:].T)
    assert bool((rec[:, rows + 1:] == 0).all())
    # the walk's rdet, gaussian by gaussian, in one tile of one splat each
    gid = torch.arange(n)[:, None]
    walk = trender._splat_chunk(feat, gid, torch.zeros(n, dtype=torch.long), 1)
    assert torch.equal(rec[:, trender.REC_RDET], walk["rdet"].reshape(n))


@pytest.mark.parametrize("case", ["fixture", "far"])
def test_packed_b1_walk_matches_plain(case):
    """B1's walk over packed records, in the kernel's batches and in batches
    of 2, against render_fwd_plain; the tiles heaviest first, as the kernel
    takes them, give the same image bit for bit as in index order."""
    feat, layout, grid = _dc_inputs(case)
    rec = trender.pack_fwd_rows_plain(feat)
    want = trender.render_fwd_plain(feat, layout.gaussian_idx, layout.tile_starts,
                                    grid.x_tiles)
    order = trender.tile_order_plain(layout.tile_starts)
    for batch in (_kernel_batch("render_fwd.cu"), SMALL_BATCH):
        _check_batches(layout, batch)
        got = packed_walk(rec, layout.gaussian_idx, layout.tile_starts, grid.x_tiles,
                          batch, dc_colour, order)
        _assert_matches(got, want)
    in_index_order = packed_walk(rec, layout.gaussian_idx, layout.tile_starts,
                                 grid.x_tiles, SMALL_BATCH, dc_colour)
    assert torch.equal(got, in_index_order)


@pytest.mark.parametrize("n_sh", trsh.KERNEL_N_SH)
@pytest.mark.parametrize("case", ["fixture", "far"])
def test_packed_b3_walk_matches_plain(case, n_sh):
    """B3's walk over packed records, colour in fused multiply-adds, in the
    kernel's batches and in batches of 2, against render_sh_fwd_plain."""
    feat, basis, layout, grid = _sh_inputs(case, n_sh)
    rec = trender.pack_fwd_rows_plain(feat)
    want = trsh.render_sh_fwd_plain(feat, basis, layout.gaussian_idx,
                                    layout.tile_starts, grid.x_tiles)
    for batch in (_kernel_batch("render_sh_fwd.cu"), SMALL_BATCH):
        _check_batches(layout, batch)
        got = packed_walk(rec, layout.gaussian_idx, layout.tile_starts, grid.x_tiles,
                          batch, sh_colour(basis), trender.tile_order_plain(layout.tile_starts))
        _assert_matches(got, want)


@pytest.mark.parametrize("case", ["far", "heavy"])
def test_tile_order_is_heaviest_first_permutation(case):
    """tile_order_plain is a permutation of the tiles with splat counts
    non-increasing along it, counts of ORDER_BUCKETS - 1 and more tied (in
    tile order, as the stable sort leaves them)."""
    if case == "far":
        starts = _dc_inputs(case)[1].tile_starts
    else:  # lists longer than the last bucket, and empty tiles
        counts = torch.tensor([5, 0, 2000, 1023, 3, 1500, 0, 1022, 5, 40000])
        starts = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)]).int()
    order = trender.tile_order_plain(starts)
    n_tiles = starts.numel() - 1
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order.long()).values, torch.arange(n_tiles))
    counts = (starts[1:] - starts[:-1]).clamp_max(trender.ORDER_BUCKETS - 1)[order.long()]
    assert bool((counts[1:] <= counts[:-1]).all())
    assert int(counts.max()) > int(counts.min())
    if case == "heavy":
        assert order.tolist() == [2, 3, 5, 9, 7, 0, 8, 4, 1, 6]


def test_kernel_launchers_all_declared():
    """Every launcher the kernels' sources export has a ctypes signature in
    ``_build.SIGNATURES["kernels"]``, the pack's included, and each matches
    its C parameters in number (tests/test_torch_probes.py holds each
    parameter's type)."""
    exported = set()
    for src in _build.sources("kernels"):
        exported |= set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
    assert exported == set(_build.SIGNATURES["kernels"])
    assert {"gs_pack_fwd_rows", "gs_tile_order"} <= exported
    for name, argtypes in _build.SIGNATURES["kernels"].items():
        assert len(_c_params("kernels", name)) == len(argtypes), name
    assert _c_params("kernels", "gs_pack_fwd_rows") == [
        "const float* feat", "int n", "int rows", "float* rec", "cudaStream_t stream"]


def test_pack_and_order_wrappers_need_cuda():
    """The pack's and the tile order's wrappers launch their kernels or
    raise: no plain fallback for a CPU tensor."""
    with pytest.raises(ValueError, match="CUDA"):
        trender.pack_fwd_rows_cuda(torch.zeros(cc.N_FEAT, 4))
    with pytest.raises(ValueError, match="CUDA"):
        trender.tile_order_cuda(torch.zeros(5, dtype=torch.int32))
