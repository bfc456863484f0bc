"""Hopper counterparts of the TPU probes under the top-level ``experiments/``.

Each probe asks a question about a mechanism that the JAX package's layout
was built on, and answers it on the H100 with a hand-written CUDA kernel, a
plain PyTorch version of the same function and one PyTorch library call as
the yardstick:

- ``permute_probe`` (E1): a group-local permutation of int32 rows, against
  ``Tensor.scatter_`` and ``torch.sort``;
- ``cumsum_bench`` (E2): a segmented exclusive prefix sum, against
  ``torch.cumsum``;
- ``dma_scatter_bench`` (E3): placing row blocks at data-dependent offsets,
  against ``Tensor.index_copy_``.

Beside them, the reference-scale run's two scripts, twins of the JAX
package's ``experiments/refscale_run.sh`` and ``make_bench_scene.py``:
``refscale_run`` trains the synthetic reference-scale scene through the
full 7k schedule with ``train_torch.main``, and ``make_bench_scene`` cuts
a bootstrap sample from a checkpoint.  And the twins of
``experiments/kernel_bench.py`` and ``sort_bench.py``: ``kernel_bench``
holds B1 and B2 to their plain versions and times them at the JAX
package's bench point (1,970,487 splats), ``sort_bench`` times
``torch.sort`` by operand count, int64 rows, batched rows and the
layout's int64 key.

Every probe module runs its JAX probe's sweep from its ``main()``:

    python -m gaussian_splatting_torch.experiments.permute_probe [--device cuda]

On ``--device cpu`` the dispatchers run the plain versions, at a cut size
of the port's own (2^12 elements, columns or rows).  The kernels are built into
a library of their own (``_build.library("probes")``), apart from the
package's.  Like the rest of the package, these modules import torch and
numpy, never jax.
"""

from __future__ import annotations

import argparse

import torch


def probe_args(description: str, argv=None):
    """The probes' command line: ``--device``, cuda by default."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (the plain version, at the "
                         "probe's cut CPU size)")
    return ap.parse_args(argv)


def device_label(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sort_ms(timer, keys) -> dict:
    """The sort the probes compare with: ms of ``torch.sort`` of these int32
    keys, and of a stable sort of them widened to int64, the key type of
    ``culling.build_layout``."""
    wide = keys.to(torch.int64)
    return dict(keys=keys.numel(),
                int32_ms=timer.ms(lambda: torch.sort(keys)),
                int64_stable_ms=timer.ms(lambda: torch.sort(wide, stable=True)))


def sort_line(sort: dict) -> str:
    m = sort["keys"] / 1e6
    return (f"torch.sort of {sort['keys']} int32 keys: {sort['int32_ms']:.4f} ms, "
            f"{sort['int32_ms'] / m:.4f} ms/M; stable int64: "
            f"{sort['int64_stable_ms']:.4f} ms, {sort['int64_stable_ms'] / m:.4f} ms/M")
