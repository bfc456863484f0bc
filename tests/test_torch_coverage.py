"""The port's surface against the JAX package's, read from the sources with
``ast`` (never imported: some ``experiments/`` scripts set JAX options when
they are imported).

Two levels:

- functions: every public (no leading underscore) top-level ``def`` or
  ``class`` of every module of ``gaussian_splatting_tpu/`` and of the
  top-level scripts ``train.py``, ``render.py`` and ``__graft_entry__.py``
  (a) has a function or class of the same name in the port's module of the
  same relative path under ``gaussian_splatting_torch/``, or (b) is in
  ``MAPPED`` with a counterpart that exists, or (c) is in ``EXCLUDED`` with
  a one-line reason;
- files: every file under ``experiments/`` and ``bench.py`` has a twin of
  the same stem under ``gaussian_splatting_torch/experiments/``, or is in
  ``MAPPED`` or ``EXCLUDED``.

``EXCLUDED`` is the one list of what the port leaves out by design.  To add
an entry, key it as the tables below are keyed ("path" for a file,
"path::name" for a function or class, paths from the repository's root)
and give the reason in one line; a ``MAPPED`` entry names its counterpart
the same way.  Nothing is asserted in the other direction: the port may
have more modules and names than the JAX package.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = "gaussian_splatting_tpu"
PORT_PKG = "gaussian_splatting_torch"
SCRIPTS = ("train.py", "render.py", "__graft_entry__.py")
TWINS = f"{PORT_PKG}/experiments"

# JAX name or file -> the port's counterpart under another name or path
MAPPED = {
    f"{JAX_PKG}/parallel/mesh.py::make_mesh": f"{PORT_PKG}/parallel/comm.py::make_mesh",
    f"{JAX_PKG}/parallel/gsharded.py::make_model_mesh":
        f"{PORT_PKG}/parallel/comm.py::make_model_mesh",
    f"{JAX_PKG}/parallel/gsharded.py::make_2d_mesh": f"{PORT_PKG}/parallel/comm.py::make_2d_mesh",
    "train.py::build_parser": "train_torch.py::build_parser",
    "train.py::make_synthetic_scene_data":
        f"{PORT_PKG}/dataio/dataset.py::make_synthetic_scene_data",
    "train.py::main": "train_torch.py::main",
    "render.py::build_parser": "render_torch.py::build_parser",
    "render.py::orbit_poses": "render_torch.py::orbit_poses",
    "render.py::main": "render_torch.py::main",
    # the compile check of the JAX entry point; the port's is its chip smoke run
    "__graft_entry__.py::entry": "chip_smoke.py::main",
    "__graft_entry__.py::dryrun_multichip": f"{PORT_PKG}/parallel/dryrun.py::dryrun_multigpu",
    "experiments/refscale_run.sh": f"{TWINS}/refscale_run.py",
}

_CAPACITY = ("XLA static shapes: the port's layout holds exactly the live splats, "
             "so it has no capacity to size")
_STEP_META = ("Pallas grid metadata for chunked steps over padded tile windows; "
              "the CUDA kernels walk tile_starts directly")
EXCLUDED = {
    f"{JAX_PKG}/culling.py::capacity_bucket": _CAPACITY,
    f"{JAX_PKG}/culling.py::capacity_want": _CAPACITY,
    f"{JAX_PKG}/ops/render.py::build_step_meta": _STEP_META,
    f"{JAX_PKG}/ops/render.py::expand_step_meta": _STEP_META,
    f"{JAX_PKG}/ops/render.py::num_steps": _STEP_META,
    f"{JAX_PKG}/ops/render.py::pad_feature_rows":
        "pads rows to the Pallas kernels' FEAT_ROWS; the CUDA kernels pack their "
        "own records (gs_pack_fwd_rows)",
    f"{JAX_PKG}/ops/render.py::default_interpret":
        "Pallas interpret mode off the TPU; on the CPU the port runs each kernel's "
        "plain PyTorch version",
    f"{JAX_PKG}/trainer.py::train_steps_scan":
        "lax.scan multi-step dispatch, a TPU dispatch; the port's runner takes one "
        "train_step a step",
    f"{JAX_PKG}/optim.py::make_optimizer":
        "builds the optax chain; the port's counterpart is optim.init + optim.update",
    f"{JAX_PKG}/optim.py::scale_by_leaf":
        "an optax transformation of make_optimizer's chain; optim.update applies "
        "lr_multipliers itself",
    "experiments/adc_compile_probe.py":
        "TPU capacity and dispatch machinery: compile times of the ADC variants",
    "experiments/dispatch_probe.py": "TPU dispatch machinery: lax.scan dispatch overhead",
    "experiments/tier_ladder.py": "TPU capacity machinery: the tier ladder's capacities",
    "experiments/area_dump.py": "TPU capacity machinery: window areas to size the tiers",
    "experiments/bench_tightcaps.py":
        "TPU capacity machinery: bench runs at tight capacities",
    "experiments/verify_backward_algebra.py":
        "proves the TPU backward's moment-matmul identities, which the port's "
        "atomics-based B2 and B4 do not use",
    "experiments/trace_step.py":
        "traces a step of bench.py's scene (bench.build_workload): waits for the "
        "bench twin",
    "bench.py": "the JAX package's benchmark: its twin comes with the port's first "
                "benchmark",
}


def _public_names(path: pathlib.Path) -> list:
    """Public top-level def and class names of a Python source."""
    return [node.name for node in ast.parse(path.read_text(), filename=str(path)).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not node.name.startswith("_")]


def _has(ref: str) -> bool:
    """Whether "path" or "path::name" exists in the repository."""
    path, _, name = ref.partition("::")
    p = ROOT / path
    return p.is_file() and (not name or name in _public_names(p))


def _module_files() -> list:
    pkg = sorted(str(p.relative_to(ROOT)) for p in (ROOT / JAX_PKG).rglob("*.py"))
    return pkg + list(SCRIPTS)


def _script_files() -> list:
    exp = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "experiments").iterdir()
                 if p.is_file())
    return exp + ["bench.py"]


def _port_module(rel: str):
    """The port's module of the same relative path, None for a top-level
    script (whose names are all mapped)."""
    return PORT_PKG + rel[len(JAX_PKG):] if rel.startswith(JAX_PKG + "/") else None


@pytest.mark.parametrize("rel", _module_files())
def test_every_public_name_has_a_counterpart(rel):
    port = _port_module(rel)
    if port is not None:
        assert (ROOT / port).is_file() or rel in EXCLUDED, (
            f"{rel} has no port module {port} and no EXCLUDED entry")
    missing = []
    for name in _public_names(ROOT / rel):
        key = f"{rel}::{name}"
        if key in MAPPED:
            assert _has(MAPPED[key]), f"{key} is mapped to {MAPPED[key]}, which does not exist"
        elif key not in EXCLUDED and not (port and _has(f"{port}::{name}")):
            missing.append(name)
    assert not missing, (
        f"{rel}: public names with no counterpart in {port or 'the port'}, no MAPPED "
        f"and no EXCLUDED entry: {missing}")


@pytest.mark.parametrize("rel", _script_files())
def test_every_experiment_script_has_a_twin(rel):
    twin = f"{TWINS}/{pathlib.Path(rel).stem}.py"
    if rel in MAPPED:
        assert _has(MAPPED[rel]), f"{rel} is mapped to {MAPPED[rel]}, which does not exist"
    else:
        assert rel in EXCLUDED or _has(twin), (
            f"{rel} has no twin {twin} and no MAPPED or EXCLUDED entry")


def test_the_tables_are_current():
    """Every entry names a JAX file or public name that exists, an excluded
    name has no same-name counterpart (else the entry is stale), the tables
    do not overlap, and every reason is one line."""
    assert not set(MAPPED) & set(EXCLUDED)
    scripts = set(_script_files())
    for key in list(MAPPED) + list(EXCLUDED):
        path, _, name = key.partition("::")
        if name:
            assert path in _module_files() and _has(key), f"stale entry {key}"
        else:
            assert path in scripts, f"stale entry {key}"
    for key, reason in EXCLUDED.items():
        path, _, name = key.partition("::")
        if name:
            port = _port_module(path) and f"{_port_module(path)}::{name}"
        else:
            port = f"{TWINS}/{pathlib.Path(path).stem}.py"
        assert not (port and _has(port)), f"{key} is EXCLUDED but the port has {port}"
        assert reason.strip() and "\n" not in reason, key
