"""The algebra of the depth kernel B5 (``csrc/depth_fwd.cu``) on its packed
records, on the CPU.

On the card B5 reads the records of B1's pack (``pack_fwd_rows_plain``,
which the kernel ``gs_pack_fwd_rows`` matches bitwise): for the (7, N)
depth rows, two 16-byte words u, v, op, a, b, c, rdet, distance.  A
test-local plain torch model of the kernel's walk reads only those records:
one 16x16 tile at a time, 256 threads of one pixel each, batches of the
kernel's size (and of 2, so that tile lengths are not multiples of the
batch), each pixel's stop at its crossing and the block's exit once every
pixel has crossed, with the tiles taken heaviest first
(``tile_order_plain``).  It forms alpha with the operations of the plain
walk in their order and multiplies T one splat at a time, so it is held
bit for bit against ``depth_fwd_plain(chunk=1)``, on the 6-gaussian
fixture and on the wide-splat scene of ``tests/test_torch_bwd_staged.py``,
at alpha thresholds 0.2 and 0.5.  The launcher's C signature, its
wrapper's refusal of CPU tensors and the pack's row check at the depth
matrix's 7 rows are pinned too.
"""

import pytest
import torch

from gaussian_splatting_torch import _build
from gaussian_splatting_torch.culling import build_layout
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.ops import depth as tdepth
from gaussian_splatting_torch.ops import render as trender
from gaussian_splatting_torch.structs import TILE_PX
from tests.test_torch_bwd_staged import _far_rows
from tests.test_torch_fwd_packed import SMALL_BATCH, _kernel_batch
from tests.test_torch_probes import _c_params
from tests.test_torch_render import _fixture_rows

REC_DIST = trender.REC_RDET + 1  # the distance's float in a depth record


def _depth_inputs(case):
    """(7, N) depth rows, the layout and the grid: the fixture's view or the
    seeded scene with wide splats, with each splat's depth as its
    distance."""
    rows, grid = _fixture_rows() if case == "fixture" else _far_rows()
    u, v, op, c0, c1, c2, _, _, _, z = [torch.tensor(x) for x in rows]
    layout = build_layout(u, v, (c0, c1, c2), z, torch.ones_like(z, dtype=torch.bool),
                          grid, 3.0, opacity=op)
    return tdepth.depth_feature_rows(u, v, op, c0, c1, c2, z), layout, grid


def packed_depth_walk(rec, gaussian_idx, tile_starts, x_tiles, alpha_threshold,
                      batch, order):
    """B5's walk over packed records: (n_tiles * 256,) depth, -1 where no
    splat crosses.  Block i takes tile order[i]; thread p owns pixel p."""
    n_tiles = tile_starts.numel() - 1
    half = (TILE_PX - 1) / 2
    p = torch.arange(cc.PIXELS_PER_TILE)
    up = (p % TILE_PX).float() - half
    vp = (p // TILE_PX).float() - half
    out = torch.full((n_tiles * cc.PIXELS_PER_TILE,), -1.0)
    starts = tile_starts.tolist()
    for tile in order.tolist():
        ox, oy = float((tile % x_tiles) * TILE_PX), float((tile // x_tiles) * TILE_PX)
        T = torch.ones(cc.PIXELS_PER_TILE)
        depth = torch.full((cc.PIXELS_PER_TILE,), -1.0)
        found = torch.zeros(cc.PIXELS_PER_TILE, dtype=torch.bool)
        lo, hi = starts[tile], starts[tile + 1]
        for base in range(lo, hi, batch):
            # the batch's records, u and v made tile-local as they are staged
            st = rec[gaussian_idx[base:min(base + batch, hi)].long()].clone()
            st[:, 0] = (st[:, 0] - ox) - half
            st[:, 1] = (st[:, 1] - oy) - half
            for sj in st:
                ul, vl, op, a, b, c, rdet, dist = sj
                du, dv = up - ul, vp - vl
                mh = (c * du * du - 2.0 * b * du * dv + a * dv * dv) * rdet
                alpha = op * torch.where(mh > 0.0, torch.exp(-0.5 * mh), torch.zeros_like(mh))
                # a pixel that has crossed takes no more splats
                T = torch.where(found, T, T * (1.0 - alpha))
                new = ~found & ((1.0 - T) > alpha_threshold)
                depth = torch.where(new, dist, depth)
                found |= new
            # the block leaves once every pixel has crossed
            if bool(found.all()):
                break
        out[tile * cc.PIXELS_PER_TILE:(tile + 1) * cc.PIXELS_PER_TILE] = depth
    return out


@pytest.mark.parametrize("alpha_threshold", [0.2, 0.5])
@pytest.mark.parametrize("case", ["fixture", "far"])
def test_packed_b5_walk_matches_plain_bitwise(case, alpha_threshold):
    """B5's walk over packed records, tiles heaviest first, in the kernel's
    batches and in batches of 2: the depth of every pixel bit for bit that
    of depth_fwd_plain(chunk=1), which takes the tiles in index order."""
    feat, layout, grid = _depth_inputs(case)
    rec = trender.pack_fwd_rows_plain(feat)
    args = (layout.gaussian_idx, layout.tile_starts, grid.x_tiles, alpha_threshold)
    want = tdepth.depth_fwd_plain(feat, *args, chunk=1)
    hits = want >= 0
    # the inputs reach both outcomes, and some pixel crosses past its first splat
    assert 0 < int(hits.sum()) < want.numel()
    counts = layout.tile_counts
    assert bool((counts % SMALL_BATCH != 0).any()) and int(counts.max()) > SMALL_BATCH
    order = trender.tile_order_plain(layout.tile_starts)
    assert not torch.equal(order.long(), torch.arange(order.numel()))
    for batch in (_kernel_batch("depth_fwd.cu"), SMALL_BATCH):
        got = packed_depth_walk(rec, *args, batch, order)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), batch
    in_index_order = packed_depth_walk(rec, *args, SMALL_BATCH,
                                       torch.arange(order.numel()))
    assert torch.equal(got, in_index_order)


def test_depth_records_carry_the_distance():
    """The depth rows' records are (N, 8): rdet at float 6, the distance at
    float 7, filling the second 16-byte word with no padding."""
    feat, _, _ = _depth_inputs("far")
    rec = trender.pack_fwd_rows_plain(feat)
    assert trender.packed_stride(tdepth.N_DEPTH_FEAT) == 8
    assert tuple(rec.shape) == (feat.shape[1], 8)
    assert torch.equal(rec[:, REC_DIST], feat[tdepth.FEAT_DEPTH])
    a, b, c = feat[cc.FEAT_A], feat[cc.FEAT_B], feat[cc.FEAT_C]
    assert torch.equal(rec[:, trender.REC_RDET], 1.0 / (a * c - b * b))


def test_depth_launcher_signature():
    """gs_depth_fwd takes the pack's records, the layout and the tile order,
    as ``_build.SIGNATURES`` declares."""
    assert _c_params("kernels", "gs_depth_fwd") == [
        "const float* rec", "const int* gaussian_idx", "const int* tile_starts",
        "const int* tile_order", "int n_tiles", "int x_tiles", "float alpha_threshold",
        "float* out", "cudaStream_t stream"]
    P, I, F = _build._P, _build._I, _build._F
    assert _build.SIGNATURES["kernels"]["gs_depth_fwd"] == (P, P, P, P, I, I, F, P, P)


def test_depth_wrappers_need_cuda():
    """depth_fwd_cuda launches the kernel or raises: no plain fallback for a
    CPU tensor.  The pack takes the depth matrix's 7 rows (it refuses 6)."""
    feat, layout, grid = _depth_inputs("fixture")
    with pytest.raises(ValueError, match="CUDA"):
        tdepth.depth_fwd_cuda(feat, layout.gaussian_idx.int(),
                              layout.tile_starts.int(), grid.x_tiles, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        trender.pack_fwd_rows_cuda(feat)  # past the row check
    with pytest.raises(ValueError, match="rows > 6"):
        trender.pack_fwd_rows_cuda(feat[:6])
