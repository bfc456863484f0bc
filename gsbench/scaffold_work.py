"""The yardstick of a Scaffold-GS training step: its float32 operations on
the inputs of a traced step, counted from the plain statement of each part
(``reference/scaffold.py``), never read from the program.

A step's operations, on one traced step's counts (``traffic/scaffold.py``
adds ``anchors``, ``anchor_slots`` and ``mlp_floats`` to the pairs of
``work.pair_counts`` on the step's neural gaussians, whose ``alive`` is the
neural gaussians rendered):

- the pairs forward (B1) and backward (B2), ``work.kernel_work``;
- per neural gaussian, the geometry (``work.GEOMETRY_OPS``) forward and,
  at ``work.BACKWARD_FACTOR``, backward;
- per anchor decoded, the three MLPs' products and activations forward
  and backward, and the neural gaussians' decode (``DECODE_OPS`` per
  candidate);
- Adam over every float of the leaves (``work.ADAM_OPS_PER_FLOAT``): the
  anchor slots' offsets, features and scalings, and the MLPs;
- per pixel the loss, forward and backward (``work.LOSS_OPS``).
"""

from __future__ import annotations

from gsbench import work
from gsbench.reference import splat

# the MLPs: three first layers 35 -> 32, the heads 32 -> 10, 70 and 30; a
# multiply-add is two operations
FEAT_IN, HIDDEN, HEAD_WIDTHS, N_OFFSETS = 35, 32, (10, 70, 30), 10
MLP_OPS = 2 * (3 * FEAT_IN * HIDDEN + HIDDEN * sum(HEAD_WIDTHS))
# per anchor beside the products: the view direction and its norm 12, the
# three hidden layers' bias and ReLU 2 * 96, the heads' biases 110, tanh
# and sigmoid 4 * 40
ANCHOR_OPS = 12 + 2 * 3 * HIDDEN + sum(HEAD_WIDTHS) + 4 * (10 + 30)
# per candidate neural gaussian: the offset's scale and the add 6, the
# scale's sigmoid and product 15
DECODE_OPS = 21
# floats a slot holds of the anchor leaves: offsets 30, feature 32, scaling 6
SLOT_FLOATS = 3 * N_OFFSETS + 32 + 6


def step_ops(c: dict):
    """float32 operations of one training step on one traced step's
    counts ``c``; None if ``c`` is not a Scaffold-GS step's."""
    if "anchors" not in c:
        return None
    k = work.kernel_work(c)
    n_pix = c["tiles"] * splat.PIXELS
    fb = 1 + work.BACKWARD_FACTOR
    ops = k["render_fwd"][1] + k["render_bwd"][1]
    ops += c["alive"] * work.GEOMETRY_OPS * fb
    ops += c["anchors"] * ((MLP_OPS + ANCHOR_OPS) * fb + N_OFFSETS * DECODE_OPS * fb)
    ops += (c["anchor_slots"] * SLOT_FLOATS + c["mlp_floats"]) * work.ADAM_OPS_PER_FLOAT
    ops += n_pix * 3 * work.LOSS_OPS * fb
    return float(ops)


def mfu(t):
    """Percent of the card's float32 peak that a whole Scaffold-GS step
    reached: the operations of the traced steps' inputs (``step_ops``),
    averaged over them, over the seconds a step took on the host's clock
    in the same run outside the traced stretch; None if nothing was
    counted or the stretch is not a Scaffold-GS one."""
    ops = [step_ops(c) for c in t.work]
    if not ops or None in ops or not t.step_s:
        return None
    return 100.0 * sum(ops) / len(ops) / (t.step_s * work.PEAK_F32_PER_S)
