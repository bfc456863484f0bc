"""The benchmark of the PyTorch/CUDA port ``gaussian_splatting_torch``.

``run.py`` runs one cell once; ``spec`` finds the cells' data and code by
name; ``scene`` and the makers in ``scenes/`` make the inputs from the
seed; the kinds in ``traffic/`` drive the traffic through the program, on
what ``harness`` gives them; ``check`` decides ``correct`` against the
plain reference (``reference/``); ``trace`` and ``work`` give the per-layer
metrics that the readers in ``metrics/`` report; ``readings`` makes the
readings the limits are set from.  Nothing here imports JAX or the JAX
package.
"""
