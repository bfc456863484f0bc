"""The whole served view's share of the card's float32 peak, in percent
(``work.mfu``): the pairs forward, per-gaussian geometry and SH, over a
view's time on the host's clock."""

from gsbench import work


def read(t):
    return work.mfu(t, train=False)
