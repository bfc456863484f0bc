"""Ranks, process groups and collectives of the port's multi-GPU training
(the counterpart of ``jax.sharding.Mesh`` and of the JAX package's
``all_gather``, ``psum``, ``pmean`` and ``pmax``).

A ``Mesh`` is this rank's view of a (data, model) layout of
``dp * mp`` ranks: rank r sits at (r // mp, r % mp), as
``make_2d_mesh``'s reshape places devices in the JAX package.  Its data
group holds the dp ranks that share r's model index (they own the same
slots and render different cameras); its model group holds the mp ranks
that share r's data index (they split the scene's slots and the image's
tile-row bands).  ``make_mesh`` (dp only) and ``make_model_mesh`` (mp only)
are the two one-dimensional layouts.

``launch`` starts the ranks: one spawned process each, rendezvous through
a ``file://`` store in a new temporary directory, so concurrent runs never
contend for a port.  The backend is chosen from the device count alone:

- ``cpu``: gloo;
- ``cuda`` with at least as many cards as ranks: NCCL, rank r on cuda:r;
- ``cuda`` with fewer cards than ranks: the ranks share the cards
  (rank r on cuda:{r % count}) over gloo, and ``launch`` says so.  NCCL
  will not put two ranks on one card.

Gloo in torch 2.11 runs every collective used here on CUDA tensors
(all_gather_into_tensor, reduce_scatter_tensor, all_reduce with sum, max
and min, broadcast; checked on an H100), copying through the host itself,
so no collective is staged by hand.  Gloo moves no bool tensors, so masks
travel as uint8.  Each collective runs in a ``gs::comm.<op>`` span
(``telemetry.py``).

A rank that raises fails the run: ``launch`` stops the other ranks and
raises that rank's exception in the caller.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
import warnings

import torch
import torch.distributed as dist

from gaussian_splatting_torch import telemetry

# seconds a collective may wait for a peer before it fails the rank
TIMEOUT_S = 1800
# seconds launch waits for the other ranks after one has failed
GRACE_S = 10


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, mp) layout, its device and its groups."""

    dp: int
    mp: int
    rank: int
    device: torch.device
    backend: str
    data_group: object  # the dp ranks with this rank's model index
    model_group: object  # the mp ranks with this rank's data index

    @property
    def world(self) -> int:
        return self.dp * self.mp

    @property
    def data_rank(self) -> int:
        return self.rank // self.mp

    @property
    def model_rank(self) -> int:
        return self.rank % self.mp


def backend_for(device_type: str, n_ranks: int) -> str:
    """gloo on the CPU or when ranks share cards, NCCL when every rank has
    a card of its own."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no process-group backend for device type {device_type!r}")
    return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or cuda:{rank % card count}."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_2d_mesh(d_data: int, d_model: int, *, device_type: str) -> Mesh:
    """The (d_data, d_model) layout over every rank of the process group.
    Every rank must call it, in the same order as its other groups."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if d_data * d_model != world:
        raise ValueError(f"a ({d_data}, {d_model}) mesh needs {d_data * d_model} ranks, "
                         f"the process group has {world}")
    # new_group is collective: every rank creates every group, in one order
    data_groups = [dist.new_group([d * d_model + m for d in range(d_data)])
                   for m in range(d_model)]
    model_groups = [dist.new_group([d * d_model + m for m in range(d_model)])
                    for d in range(d_data)]
    return Mesh(dp=d_data, mp=d_model, rank=rank,
                device=rank_device(device_type, rank), backend=dist.get_backend(),
                data_group=data_groups[rank % d_model],
                model_group=model_groups[rank // d_model])


def make_mesh(*, device_type: str) -> Mesh:
    """Data parallelism over every rank."""
    return make_2d_mesh(dist.get_world_size(), 1, device_type=device_type)


def make_model_mesh(*, device_type: str) -> Mesh:
    """Gaussian sharding over every rank."""
    return make_2d_mesh(1, dist.get_world_size(), device_type=device_type)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (``all_gather_into_tensor``); not differentiable (``all_gather`` is)."""
    if x.dtype == torch.bool:
        return gather(x.to(torch.uint8), dim, group).bool()
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    with telemetry.span("gs::comm.gather"):
        dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of each rank's ``x``, split along ``dim`` into
    group-size parts; rank j keeps part j (``reduce_scatter_tensor``)."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"reduce_scatter: {xs.shape[0]} rows do not split into {n} parts")
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    with telemetry.span("gs::comm.reduce_scatter"):
        dist.reduce_scatter_tensor(out, xs, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A new tensor: ``op`` (a ``dist.ReduceOp``) of the group's ``x``."""
    out = x.clone()
    with telemetry.span("gs::comm.all_reduce"):
        dist.all_reduce(out, op=op, group=group)
    return out


def all_sum(x, group):
    return all_reduce(x, dist.ReduceOp.SUM, group)


def all_ok(ok: torch.Tensor) -> torch.Tensor:
    """A 0-d bool that is True where ``ok`` is True on every rank of the
    process group."""
    return all_reduce(ok.to(torch.int32), dist.ReduceOp.MIN, None) > 0


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of ``group``, as a new
    tensor."""
    if x.dtype == torch.bool:
        return broadcast(x.to(torch.uint8), src, group).bool()
    out = x.clone()
    with telemetry.span("gs::comm.broadcast"):
        dist.broadcast(out, src, group=group)
    return out


class AllGather(torch.autograd.Function):
    """``gather`` with its VJP: the cotangent of the concatenation is
    summed over the group and each rank keeps the part of its own input
    (``reduce_scatter``), which is exactly JAX's transpose of
    ``all_gather(tiled=True)``."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.dim, ctx.group), None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The differentiable gather along ``dim`` over ``group``."""
    return AllGather.apply(x, dim, group)


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def _worker(rank, n_ranks, backend, device_type, init_file, result_dir, threads, fn, args):
    """One rank: join the process group, run fn(*args), leave its result
    (or its exception) in result_dir/<rank>.pkl."""
    # newer torch renames the two tensor collectives *_single; these names work
    warnings.filterwarnings("ignore", message=".*is deprecated.*_single", category=FutureWarning)
    torch.set_num_threads(threads)
    device = rank_device(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    path = os.path.join(result_dir, f"{rank}.pkl")
    code, failed_at = 0, None
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=n_ranks,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            out = ("ok", fn(*args))
        except BaseException:
            failed_at = time.time()  # before the peers see this rank leave
            raise
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # reported to the caller, then the rank exits nonzero
        code = 1
        text = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:  # an exception that cannot cross processes
            e = RuntimeError(f"{type(e).__name__}: {e}")
        out = ("error", e, text, failed_at or time.time())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)
    if code:
        raise SystemExit(code)


def launch(fn, n_ranks: int, *args, device_type: str = "cuda"):
    """Run ``fn(*args)`` on ``n_ranks`` spawned ranks joined in one process
    group, and return their results in rank order.  ``fn`` must be
    importable (a module-level function).  Each rank gets an equal share of
    the CPU's cores for torch's threads.

    When a rank fails, the others are stopped and the failing rank's
    exception is raised here, with its traceback as the note; a rank that
    dies without one raises ``RuntimeError`` with its exit code."""
    import multiprocessing

    backend = backend_for(device_type, n_ranks)
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count < n_ranks:
            print(f"[comm] {n_ranks} ranks share {count} CUDA card(s) over gloo "
                  f"(rank r on cuda:{{r % {count}}}); NCCL needs a card a rank", flush=True)
        from gaussian_splatting_torch import _build

        _build.build("kernels")  # once here, so the ranks only load it
    threads = max(1, (os.cpu_count() or 1) // n_ranks)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gs_ranks_")
    procs = []
    try:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker, args=(r, n_ranks, backend, device_type, init_file,
                                                   tmp, threads, fn, args))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        failed_at = None
        while any(p.is_alive() for p in procs):
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = time.monotonic()
            if failed_at is not None and time.monotonic() - failed_at > GRACE_S:
                for p in procs:
                    if p.is_alive():
                        p.terminate()
            time.sleep(0.05)
        for p in procs:
            p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"{r}.pkl")
            if not os.path.exists(path):
                errors.append((r, RuntimeError(f"rank {r} exited with code {p.exitcode} "
                                               "and no result"), "", float("inf")))
                continue
            with open(path, "rb") as f:  # written by this run's own ranks
                out = pickle.load(f)
            if out[0] == "ok":
                results.append(out[1])
            else:
                errors.append((r, *out[1:]))
        if errors:
            # the first rank to fail; the others failed because of it
            r, exc, text, _ = min(errors, key=lambda e: (e[3], e[0]))
            exc.add_note(f"raised on rank {r} of {n_ranks}:\n{text}")
            raise exc
        return results
    finally:  # no rank outlives the call, whatever ended it
        for p in procs:
            if p.pid is not None:  # started
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
