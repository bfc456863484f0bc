"""Data parallelism over cameras (counterpart of
``gaussian_splatting_tpu/parallel/mesh.py``).

The scene and the optimizer state are replicated on the ranks of the data
group; each rank renders and differentiates its own camera, and one
all-reduce of a flat buffer averages the gradients, the loss and the PSNR
and sums the densification statistics.  Every rank then holds the same
gradients and applies the same Adam step, so the replicas stay equal
without a broadcast.  With one rank this is ``trainer.train_step``.
"""

from __future__ import annotations

import torch

from gaussian_splatting_torch import trainer as T
from gaussian_splatting_torch.parallel import comm


def reduce_over_data(gparams: dict, loss, psnr, uv_grad, seen, mesh: comm.Mesh):
    """One all-reduce over the data group: (gradients, loss and psnr
    averaged, as ``jax.lax.pmean`` forms them; uv_grad (C, 2) and seen (C,)
    int32 summed), from one flat float32 buffer."""
    names = list(gparams)
    parts = [gparams[k].reshape(-1) for k in names]
    parts += [loss.detach().reshape(1), psnr.detach().reshape(1), uv_grad.reshape(-1),
              seen.to(torch.float32)]  # counts of at most dp: exact in float32
    total = comm.all_sum(torch.cat(parts), mesh.data_group)
    out, at = [], 0
    for p in parts:
        out.append(total[at:at + p.numel()])
        at += p.numel()
    n = mesh.dp
    grads = {k: (v / n).view_as(gparams[k]) for k, v, in zip(names, out)}
    loss, psnr, uv, seen = out[len(names):]
    return (grads, (loss / n).reshape(()), (psnr / n).reshape(()), uv.view_as(uv_grad),
            seen.to(torch.int32))


def reduce_counts(counts: list, ops: str, group, mesh: comm.Mesh) -> list:
    """The group's per-rank ``counts`` (ints or 0-d tensors), count j summed
    (``ops[j] == "s"``) or maxed (``"m"``), as 0-d int64 tensors on the
    device: one small gather reduced there, so the host never waits for the
    step (the runner reads the counts late, with the loss)."""
    ints = [c for c in counts if not torch.is_tensor(c)]
    host = iter(())
    if ints:  # pinned and non-blocking: a pageable copy would wait for the device
        host = iter(torch.tensor(ints, dtype=torch.int64, pin_memory=mesh.device.type == "cuda")
                    .to(mesh.device, non_blocking=True))
    row = torch.stack([c.to(torch.int64) if torch.is_tensor(c) else next(host)
                       for c in counts])
    rows = comm.gather(row, 0, group).view(-1, row.numel())
    return [rows[:, j].sum() if op == "s" else rows[:, j].amax() for j, op in enumerate(ops)]


def dp_train_step(
    state: T.TrainState,
    gt_image: torch.Tensor,  # this rank's camera: (H, W, 3) float32 or uint8
    camera_K: torch.Tensor,
    camera_T_world: torch.Tensor,
    background_rgb: torch.Tensor,
    *,
    config,
    camera_hw: tuple,
    n_sh_band: int,
    mesh: comm.Mesh,
):
    """One data-parallel step: this rank's camera, the gradients averaged
    over the data group.  ``state`` is replicated (``replicate_state``).

    Returns (new state, info) as ``trainer.train_step``: loss and psnr the
    means over the cameras, num_splats and num_visible the maxima,
    truncated the sum (0-d tensors, like loss).  The densification statistics sum each camera's uv
    gradient (at its own fx, fy) and visibility; xyz_grad_accum adds the
    absolute mean gradient.  A step is skipped on every rank when any
    camera's loss or gradient is not finite: the averaged values, the same
    on every rank, carry it."""
    loss, (psnr, res), gparams, g_uv = T.camera_loss(
        state, gt_image, camera_K, camera_T_world, background_rgb,
        config=config, camera_hw=camera_hw, n_sh_band=n_sh_band)
    gparams, loss, psnr, uv_grad, seen = reduce_over_data(
        gparams, loss, psnr, T.uv_grad_rows(g_uv, camera_K, res.visible),
        res.visible.to(torch.int32), mesh)
    num_splats, num_visible, truncated = reduce_counts(
        [res.num_splats, res.num_visible, res.truncated], "mms", mesh.data_group, mesh)
    ok = T.step_ok(loss, gparams)
    new_state = T.adam_step(state, gparams, ok, config)
    new_state = T.accumulate(new_state, uv_grad, gparams["xyz"].abs(), seen, ok)
    info = dict(loss=loss, psnr=psnr, num_splats=num_splats, num_visible=num_visible,
                truncated=truncated, n_alive=state.alive.sum())
    return new_state, info


def replicate_state(state: T.TrainState, mesh: comm.Mesh) -> T.TrainState:
    """Data rank 0's state on every rank of its data group (a broadcast of
    each tensor)."""
    src = mesh.model_rank  # global rank of (data rank 0, this model rank)

    return T.map_state(lambda x: comm.broadcast(x, src, mesh.data_group), state)


def shard_batch(batch, mesh: comm.Mesh):
    """This rank's row of a per-camera batch (axis 0 over the data group)."""
    return batch[mesh.data_rank]
