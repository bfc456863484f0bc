"""Device ms per step in the loss's forward, the ``gs::loss`` span
(``losses.train_loss``: L1 and SSIM)."""


def read(t):
    return t.ms_per_step("loss")
