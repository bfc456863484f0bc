"""The whole Scaffold-GS training step's share of the card's float32 peak,
in percent (``scaffold_work.mfu``): the pairs forward and backward, the
neural gaussians' geometry, the three MLPs and the decode over the anchors
decoded, Adam over the leaves and the loss, over a step's time on the
host's clock."""

from gsbench import scaffold_work


def read(t):
    return scaffold_work.mfu(t)
