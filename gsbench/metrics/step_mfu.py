"""The whole training step's share of the card's float32 peak, in percent
(``work.mfu``): the pairs forward and backward, per-gaussian geometry, SH
and Adam, per-pixel loss, over a step's time on the host's clock."""

from gsbench import work


def read(t):
    return work.mfu(t, train=True)
