"""Multi-GPU training on ``torch.distributed`` (counterpart of
``gaussian_splatting_tpu/parallel``): data parallelism over cameras
(``mesh``), gaussian-sharded model parallelism (``gsharded``) and their
2D composition, over the process groups of ``comm``.  ``dryrun`` drives
every mode through the training loop's sequence of steps and events."""

from gaussian_splatting_torch.parallel.comm import make_2d_mesh, make_mesh, make_model_mesh
from gaussian_splatting_torch.parallel.gsharded import (
    dp_mp_train_step,
    mp_eval_step,
    mp_render,
    mp_train_step,
    shard_state,
)
from gaussian_splatting_torch.parallel.mesh import dp_train_step

__all__ = [
    "make_mesh",
    "dp_train_step",
    "dp_mp_train_step",
    "make_2d_mesh",
    "make_model_mesh",
    "mp_eval_step",
    "mp_render",
    "mp_train_step",
    "shard_state",
]
