"""Device ms per training step of the critic's first convolution and its
activation, forward and backward (``shapehd.critic.stem``,
``shapehd.critic.stem.backward``: K6 and its backward on K3, or the
plain layer).  None where the program opens no backward span for the
stem."""

from metrics._read import span_ms

SPANS = ("shapehd.critic.stem", "shapehd.critic.stem.backward")


def read(summary):
    if summary["span_kernel_s"].get(SPANS[1], 0.0) <= 0:
        return None
    return span_ms(summary, SPANS)
