"""Device ms per batch of the critic's first convolution and its
activation (``shapehd.critic.stem``, on both voxel grids: K6, or
``nn.Conv3d`` and ``F.leaky_relu`` where K6 does not run).  None where
the program opens no such span."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("shapehd.critic.stem",))
