"""E1: group-local permutation of int32 rows (counterpart of
``experiments/permute_probe.py``).

The question: what does it cost per million elements to place each element
of a group of G at an exact position inside the group (the last stage of a
shuffle or a sample sort), against a sort, and at which G?  For every row r
and group g:

    out[r, g*G + dest[g, j]] = vals[r, g*G + j]

with ``dest[g]`` a permutation of [0, G).

``permute`` launches the hand-written kernel ``csrc/probes/permute_probe.cu``
(which replaces the Pallas kernel ``experiments/permute_probe.py::make_permute``)
on a CUDA tensor and runs ``permute_plain`` on a CPU tensor, with no
fallback between them.  ``permute_library`` is the yardstick: one
``Tensor.scatter_``.  The kernel's source note says what bounds it.

    python -m gaussian_splatting_torch.experiments.permute_probe [--device cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_torch import _build, timing
from gaussian_splatting_torch.experiments import (
    device_label,
    probe_args,
    sort_line,
    sort_ms,
)

GROUPS = (256, 512, 1024, 2048)  # the sweep, and the kernel's templates
ROWS = 6
N = 1 << 21
N_CPU = 1 << 12  # the port's own cut for CPU runs
SEED = 0
# bytes of one batch of the plain version's float64 one-hot matrices
ONE_HOT_BYTES = 1 << 28


def group_permutations(rng, n: int, g: int) -> np.ndarray:
    """(n // g, g) int32, each row a permutation of [0, g), drawn as the
    JAX probe draws them."""
    return np.concatenate(
        [rng.permutation(g).astype(np.int32) for _ in range(n // g)]
    ).reshape(n // g, g)


def permute_reference(vals: np.ndarray, dest: np.ndarray) -> np.ndarray:
    """numpy reference, as the JAX probe checks its kernel."""
    n, g = vals.shape[1], dest.shape[1]
    idx = np.arange(n)
    want = np.empty_like(vals)
    want[:, (idx // g) * g + dest.reshape(-1)] = vals[:, idx]
    return want


def permute_plain(vals, dest):
    """Plain PyTorch version of the kernel: the JAX kernel's one-hot
    product, batched over groups so the one-hot fits in memory.

    vals: (R, N) int32; dest: (N/G, G) int32.  The payload rides as two
    16-bit halves (the high one by a logical shift, as the JAX kernel's
    ``shift_right_logical``), multiplied in float64 with the one-hot
    P[j, k] = (dest[j] == k): one term of each sum is nonzero, so the result
    is exact whatever the TF32 setting.
    """
    rows, n = vals.shape
    n_groups, g = dest.shape
    dev = vals.device
    word = vals.reshape(rows, n_groups, g).to(torch.int64) & 0xFFFFFFFF
    halves = torch.cat([word >> 16, word & 0xFFFF]).to(torch.float64)
    moved = torch.empty_like(halves)
    cols = torch.arange(g, device=dev)
    batch = max(1, ONE_HOT_BYTES // (8 * g * g))
    for g0 in range(0, n_groups, batch):
        one_hot = (dest[g0:g0 + batch, :, None].long() == cols).to(torch.float64)
        moved[:, g0:g0 + batch] = torch.einsum(
            "hbj,bjk->hbk", halves[:, g0:g0 + batch], one_hot)
    word = (moved[:rows].to(torch.int64) << 16) | moved[rows:].to(torch.int64)
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    return word.to(torch.int32).reshape(rows, n)


def _check_args(name, vals, dest):
    if vals.dim() != 2 or dest.dim() != 2:
        raise ValueError(f"{name}: vals (R, N) and dest (N/G, G), got "
                         f"{tuple(vals.shape)} and {tuple(dest.shape)}")
    if dest.numel() != vals.shape[1]:
        raise ValueError(f"{name}: dest covers {dest.numel()} elements, vals "
                         f"rows have {vals.shape[1]}")
    if vals.dtype != torch.int32 or dest.dtype != torch.int32:
        raise TypeError(f"{name}: vals and dest must be int32")


def permute_cuda(vals, dest):
    """Launch the kernel on the current stream; same contract as
    ``permute_plain``, for G in ``GROUPS``."""
    _check_args("permute", vals, dest)
    g = dest.shape[1]
    if not vals.is_cuda or dest.device != vals.device:
        raise ValueError(f"permute: the kernel needs vals and dest on one CUDA "
                         f"device, got {vals.device} and {dest.device}")
    if g not in GROUPS:
        raise ValueError(f"permute: the kernel takes G in {GROUPS}, got {g}")
    if not (vals.is_contiguous() and dest.is_contiguous()):
        raise ValueError("permute: vals and dest must be contiguous")
    out = torch.empty_like(vals)
    err = _build.library("probes").gs_permute_probe(
        vals.data_ptr(), dest.data_ptr(), vals.shape[1], vals.shape[0], g,
        out.data_ptr(), torch.cuda.current_stream(vals.device).cuda_stream,
    )
    _build.check(err, "gs_permute_probe")
    _build.LAUNCHES["permute_probe"] += 1
    return out


def permute(vals, dest):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    _check_args("permute", vals, dest)
    if vals.is_cuda:
        return permute_cuda(vals, dest)
    if vals.device.type == "cpu":
        return permute_plain(vals, dest)
    raise ValueError(f"permute: no kernel for device {vals.device}")


def library_index(dest, rows: int):
    """dest as ``scatter_`` takes it: int64, expanded over the R rows."""
    return dest.long().expand(rows, -1, -1)


def permute_library(vals, index):
    """One ``Tensor.scatter_`` along the group axis of the (R, N/G, G) view;
    ``index`` from ``library_index``."""
    out = torch.empty_like(vals)
    out.view(index.shape).scatter_(2, index, vals.view(index.shape))
    return out


def sweep(device):
    """The JAX probe's sweep (G in ``GROUPS``, R = 6, seed 0; N = 2^21 on a
    CUDA device, 2^12 on the CPU), each point checked bitwise against the
    plain version and the numpy reference.  Returns (points, info): one
    dict per G, and the size, the clock and ``timing.sort_ms`` of N keys."""
    dev = torch.device(device)
    timer = timing.Timer(dev)
    n = N if timer.cuda else N_CPU
    rng = np.random.default_rng(SEED)
    vals_np = rng.integers(-(2**31), 2**31, size=(ROWS, n),
                           dtype=np.int64).astype(np.int32)
    vals = torch.from_numpy(vals_np).to(dev)
    points = []
    for g in GROUPS:
        dest_np = group_permutations(rng, n, g)
        dest = torch.from_numpy(dest_np).to(dev)
        index = library_index(dest, ROWS)
        got = permute(vals, dest)
        plain = permute_plain(vals, dest)
        lib = permute_library(vals, index)
        want = torch.from_numpy(permute_reference(vals_np, dest_np)).to(dev)
        ok = bool(torch.equal(got, plain) and torch.equal(got, want)
                  and torch.equal(lib, want))
        err = int((got.long() - plain.long()).abs().max())
        ms, plain_ms, lib_ms = timing.compare(
            timer, lambda: permute(vals, dest), lambda: permute_plain(vals, dest),
            lambda: permute_library(vals, index))
        points.append(dict(
            point=f"G={g}", ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bytes=(2 * ROWS + 1) * n * 4, ops=0, max_abs_err=err, ok=ok,
            ms_per_million=ms / (n / 1e6)))
        del dest, index, got, plain, lib, want
    sort = sort_ms(timer, vals[0].contiguous())
    return points, dict(n=n, clock=timer.clock, sort=sort)


def main(argv=None):
    args = probe_args("E1: group-local permutation of int32 rows", argv)
    points, info = sweep(args.device)
    n = info["n"]
    print(f"E1 permute on {device_label(args.device)}: N={n}, R={ROWS} "
          f"int32 rows ({info['clock']})", flush=True)
    for p in points:
        print(f"{p['point']:>7s}: {p['ms']:7.3f} ms  {p['ms_per_million']:.4f} "
              f"ms/M ({ROWS} i32 rows)  {p['bytes'] / p['ms'] / 1e6:7.1f} GB/s; "
              f"plain {p['plain_ms']:.3f} ms, scatter_ {p['library_ms']:.4f} ms  "
              f"{'OK' if p['ok'] else 'MISMATCH'}", flush=True)
    print(sort_line(info["sort"]))
    if not all(p["ok"] for p in points):
        raise SystemExit("E1: the kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
