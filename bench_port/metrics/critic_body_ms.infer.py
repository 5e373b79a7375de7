"""Device ms per batch of the critic's layers after the first, on both
voxel grids (``shapehd.critic.body``: its middle convolutions and their
activations on K7, or ``nn.Conv3d`` and ``F.leaky_relu`` where K7 does
not run, and the last convolution to the score).  None where the program
opens no such span."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("shapehd.critic.body",))
