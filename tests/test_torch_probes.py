"""The TPU probes E1-E3: each plain PyTorch version against its JAX probe
run in Pallas interpret mode and a numpy reference, at small sizes; the
library baselines, the dispatch of CPU tensors, the probes' command lines,
and the launchers' ctypes signatures against their C sources."""

import ctypes
import importlib
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gaussian_splatting_torch import _build, telemetry
from gaussian_splatting_torch.experiments import cumsum_bench as tcs
from gaussian_splatting_torch.experiments import dma_scatter_bench as tds
from gaussian_splatting_torch.experiments import kernel_bench as tkb
from gaussian_splatting_torch.experiments import permute_probe as tpp
from gaussian_splatting_torch.experiments import sort_bench as tsb
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

# Importing a JAX probe points JAX's persistent compilation cache at a
# directory of its own; these are the options it sets.
_CACHE_OPTIONS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")
# E2 against the float64 prefix, x uniform in [0, 1): measured at most
# 1.5e-5 for the port's plain version (rounded once from float64), 6.7e-5
# for the JAX cumsum and assoc modes and 2.6e-4 for its matmul mode at
# chunk 512 (9.7e-5 at 256), whose float32 sums reach ~256, where an ulp
# is 3.1e-5
SCAN_TOL = 5e-4


@pytest.fixture(scope="module")
def jax_probes():
    """The three JAX probe modules, with JAX's cache options restored at
    once, before anything compiles."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_OPTIONS}
    try:
        mods = {name: importlib.import_module(f"experiments.{name}")
                for name in ("permute_probe", "cumsum_bench", "dma_scatter_bench")}
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mods


def _run_jax(fn, *args):
    """A JAX probe as its script runs it: with 32-bit defaults (this suite
    turns on x64, under which the probe's int literals become int64)."""
    with jax.enable_x64(False):
        return np.asarray(fn(*[jnp.asarray(a) for a in args]))


def _permute_inputs(n, g, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-(2**31), 2**31, size=(tpp.ROWS, n),
                        dtype=np.int64).astype(np.int32)
    # words whose halves test the logical shift and the sign on the way back
    vals[0, :6] = [-(2**31), -1, 0xFFFF, -0x10000, 2**31 - 1, 0x8000]
    return vals, tpp.group_permutations(rng, n, g)


@pytest.mark.parametrize("g", [256, 512])
def test_permute_plain_matches_jax_probe(jax_probes, g):
    n = 1024
    vals, dest = _permute_inputs(n, g, seed=g)
    assert (vals < 0).any()
    want = tpp.permute_reference(vals, dest)
    got = tpp.permute_plain(torch.from_numpy(vals), torch.from_numpy(dest)).numpy()
    fn = jax_probes["permute_probe"].make_permute(n, g, tpp.ROWS, interpret=True)
    jx = _run_jax(fn, dest, vals)
    np.testing.assert_array_equal(jx, want)
    np.testing.assert_array_equal(got, want)


def _jax_scan(mod, mode, chunk, x):
    """The JAX probe's kernel body in a pallas_call with the probe's own
    BlockSpecs, in interpret mode (its ``run`` builds none)."""
    p, total = x.shape
    spec = pl.BlockSpec((p, chunk), lambda s: (0, s), memory_space=pltpu.VMEM)
    fn = pl.pallas_call(
        mod.mk_kernel(mode, chunk), grid=(total // chunk,), in_specs=[spec],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct((p, total), jnp.float32),
        interpret=True,
    )
    return _run_jax(fn, x)


@pytest.mark.parametrize("chunk", [256, 512])
@pytest.mark.parametrize("mode", ["matmul", "cumsum", "assoc"])
def test_scan_plain_matches_jax_probe(jax_probes, mode, chunk):
    x = np.random.default_rng(chunk).random((tcs.P, 2 * chunk), dtype=np.float32)
    seg = x.reshape(tcs.P, 2, chunk).astype(np.float64)
    want = (np.cumsum(seg, axis=2) - seg).reshape(x.shape)
    got = tcs.scan_plain(torch.from_numpy(x), chunk).numpy()
    jx = _jax_scan(jax_probes["cumsum_bench"], mode, chunk, x)
    assert got.dtype == jx.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=SCAN_TOL, rtol=0)
    np.testing.assert_allclose(jx, want, atol=SCAN_TOL, rtol=0)
    np.testing.assert_allclose(got, jx, atol=SCAN_TOL, rtol=0)
    assert (got[:, 0] == 0).all() and (got[:, chunk] == 0).all()


@pytest.mark.parametrize("nsub", [1, 4, 16])
def test_place_plain_matches_jax_probe(jax_probes, nsub):
    n_rows, rows_blk = 1024, 256
    sub = rows_blk // nsub
    rng = np.random.default_rng(nsub)
    x = rng.normal(size=(n_rows, tds.LANES)).astype(np.float32)
    off = rng.permutation(n_rows // sub).astype(np.int32) * sub
    want = tds.place_reference(x, off, sub)
    got = tds.place_plain(torch.from_numpy(x), torch.from_numpy(off), sub).numpy()
    fn = jax_probes["dma_scatter_bench"].make_scatter(n_rows, rows_blk, nsub,
                                                      interpret=True)
    jx = _run_jax(fn, off, x)
    np.testing.assert_array_equal(jx, want)
    np.testing.assert_array_equal(got, want)


def _probe_case(name):
    """(dispatcher, plain, library, args, library args, launch counter) of
    one probe on small CPU inputs."""
    rng = np.random.default_rng(7)
    if name == "permute":
        vals, dest = _permute_inputs(1024, 256, seed=7)
        v, d = torch.from_numpy(vals), torch.from_numpy(dest)
        return (tpp.permute, tpp.permute_plain, tpp.permute_library, (v, d),
                (v, tpp.library_index(d, tpp.ROWS)), "permute_probe")
    if name == "scan":
        x = torch.from_numpy(rng.random((tcs.P, 1024), dtype=np.float32))
        return (tcs.scan, tcs.scan_plain, tcs.scan_library, (x, 256), (x, 256),
                "scan_probe")
    x = torch.from_numpy(rng.normal(size=(512, tds.LANES)).astype(np.float32))
    off = torch.from_numpy(rng.permutation(16).astype(np.int32) * 32)
    return (tds.place, tds.place_plain, tds.place_library, (x, off, 32),
            (x, tds.library_index(off, 32), 32), "place_probe")


@pytest.mark.parametrize("name", ["permute", "scan", "place"])
def test_library_baseline_computes_the_same_function(name):
    """E1's scatter_ and E3's index_copy_ equal the plain versions bitwise;
    E2's cumsum is the inclusive prefix, the plain one plus x."""
    _, plain, library, args, lib_args, _ = _probe_case(name)
    want, got = plain(*args), library(*lib_args)
    if name == "scan":
        x = args[0]
        torch.testing.assert_close(got.reshape(x.shape) - x, want, atol=SCAN_TOL,
                                   rtol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["permute", "scan", "place"])
def test_dispatch_runs_plain_on_cpu(name):
    """A CPU tensor goes to the plain version and launches nothing; the
    kernel's wrapper refuses it rather than falling back."""
    dispatch, plain, _, args, _, counter = _probe_case(name)
    before = dict(telemetry.LAUNCHES)
    assert torch.equal(dispatch(*args), plain(*args))
    assert dict(telemetry.LAUNCHES) == before and counter not in before
    cuda = {"permute": tpp.permute_cuda, "scan": tcs.scan_cuda,
            "place": tds.place_cuda}[name]
    with pytest.raises(ValueError, match="CUDA"):
        cuda(*args)


@pytest.mark.parametrize("module", [tpp, tcs, tds])
def test_probe_main_runs_on_cpu(module, capsys):
    """Each probe's command line on the CPU: the sweep at the cut size,
    every point checked, one line per point."""
    module.main(["--device", "cpu"])
    out = capsys.readouterr().out
    n_points = {tpp: len(tpp.GROUPS), tcs: len(tcs.CHUNKS),
                tds: len(tds.BLOCK_ROWS) * len(tds.NSUBS)}[module]
    assert out.count(" OK") == n_points and "MISMATCH" not in out


def test_kernel_bench_main_runs_on_cpu(capsys):
    """The twin of ``experiments/kernel_bench.py`` on the CPU: B1 and B2's
    plain versions at the cut size (12 tiles of 64 splats, one gaussian a
    splat), each held to itself through the dispatcher, no launch."""
    before = dict(telemetry.LAUNCHES)
    res = tkb.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert dict(telemetry.LAUNCHES) == before
    assert (res["tiles"], res["splats"]) == (12, 12 * tkb.DEPTH_CPU)
    assert len(out) == 3 and out[1].startswith("B1 ") and out[2].startswith("B2, ")
    assert "share not measured on the CPU" in out[1]
    for k in ("B1", "B2"):
        assert res[k]["ok"] and 0 < res[k]["composited"] <= res[k]["evaluated"]
    # the draws: every splat centred within 4 px of its own tile
    feat, gid, starts, x_tiles, cot = tkb.bench_inputs(
        "cpu", tkb.HEIGHT_CPU, tkb.WIDTH_CPU, tkb.DEPTH_CPU)
    tile = torch.repeat_interleave(torch.arange(12), tkb.DEPTH_CPU)
    du = feat[0] - (tile % x_tiles) * 16
    dv = feat[1] - (tile // x_tiles) * 16
    assert float(du.min()) >= -4 and float(du.max()) < 20
    assert float(dv.min()) >= -4 and float(dv.max()) < 20
    assert torch.equal(gid, torch.arange(12 * tkb.DEPTH_CPU, dtype=torch.int32))
    assert torch.equal(starts, torch.arange(13, dtype=torch.int32) * tkb.DEPTH_CPU)
    assert cot.shape == (4, 12 * 256) and float(cot.abs().max()) <= 1.0


def test_sort_bench_main_runs_on_cpu(capsys):
    """The twin of ``experiments/sort_bench.py`` on the CPU at 2^12: every
    point of the ladder, each sort's keys in order, one line a point."""
    points = tsb.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    n_points = (len(tsb.OPERANDS) + len(tsb.PACKING)
                + len(tsb.BATCH_ROWS) * len(tsb.BATCH_OPERANDS) + 1)
    assert len(points) == n_points == len(out) - 1
    assert {p["kind"] for p in points} == {"global", "int64 packing", "batched",
                                           "layout key"}
    assert all(p["n"] == tsb.SIZE_CPU and p["ms"] > 0 for p in points)
    # the layout key sorts as culling.build_layout's: tile, then depth
    rng = np.random.default_rng(0)
    key, gid = tsb.layout_key(rng, 500, "cpu")
    s, g = tsb.sort_with_values(key, [gid], stable=True)
    assert torch.equal(s, key[g.long()])
    assert bool(((s >> 32)[1:] >= (s >> 32)[:-1]).all())


def _c_params(library, name):
    """The parameter list of the exported launcher ``name`` in the sources
    of ``library``."""
    pattern = re.compile(r'extern "C" int ' + name + r"\(([^)]*)\)")
    found = [m.group(1) for src in _build.sources(library)
             for m in pattern.finditer(Path(src).read_text())]
    assert len(found) == 1, f"{name}: {len(found)} definitions in {library}"
    return [" ".join(p.split()) for p in found[0].split(",")]


# c_longlong is named c_long where long has 64 bits
_C_TYPE = {"c_int": ("int",), "c_long": ("long long",),
           "c_longlong": ("long long",), "c_float": ("float",)}
_LAUNCHERS = [(lib, name) for lib, sigs in sorted(_build.SIGNATURES.items())
              for name in sorted(sigs)]


@pytest.mark.parametrize("library,name", _LAUNCHERS)
def test_launcher_signature_matches_source(library, name):
    """ctypes passes every argument as declared in ``_build.SIGNATURES``: a
    pointer or the stream as c_void_p, a 32-bit int, a 64-bit int, a float.
    A mismatch would cut pointers or shift arguments on the card."""
    params = _c_params(library, name)
    argtypes = _build.SIGNATURES[library][name]
    assert len(params) == len(argtypes)
    for param, ctype in zip(params, argtypes):
        decl = param.rsplit(" ", 1)[0]
        if ctype is ctypes.c_void_p:
            assert "*" in param or decl == "cudaStream_t", (name, param)
        else:
            kinds = _C_TYPE[ctype.__name__]
            assert "*" not in param and decl.replace("const ", "") in kinds, (name, param)


def test_probes_build_apart_from_the_package_kernels(tmp_path, monkeypatch):
    """The probes' sources are a library of their own: the package's library
    holds B1-B5, the Adam step, the geometry pair and the layout only, and
    editing a probe changes the probes' library name (so it is rebuilt) and
    leaves the package's as it was."""
    kernels = {src.name for src in _build.sources("kernels")}
    probes = {src.name for src in _build.sources("probes")}
    assert kernels == {"render_fwd.cu", "render_bwd.cu", "render_sh_fwd.cu",
                       "render_sh_bwd.cu", "depth_fwd.cu", "adam.cu", "geometry.cu",
                       "layout.cu"}
    assert probes == {"permute_probe.cu", "cumsum_scan.cu", "dma_scatter.cu"}
    before = {lib: _build.library_path(lib) for lib in ("kernels", "probes")}
    assert before["kernels"].name.startswith("libgs_kernels_")
    assert before["probes"].name.startswith("libgs_probes_")
    # the same sources in a copy of csrc/, then one probe edited
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setitem(_build.SOURCE_DIRS, "kernels", src)
    monkeypatch.setitem(_build.SOURCE_DIRS, "probes", src / "probes")
    assert {lib: _build.library_path(lib) for lib in before} == before
    edited = src / "probes" / "dma_scatter.cu"
    edited.write_text(edited.read_text() + "\n")
    assert _build.library_path("kernels") == before["kernels"]
    assert _build.library_path("probes") != before["probes"]
