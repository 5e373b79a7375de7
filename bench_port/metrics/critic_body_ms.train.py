"""Device ms per training step of the frozen critic's layers after the
first, forward and backward (``shapehd.critic.body``,
``shapehd.critic.body.backward``: K7 and its backward, or the plain
layers, and the last convolution to the score).  None where the program
opens no backward span for the body."""

from metrics._read import span_ms

SPANS = ("shapehd.critic.body", "shapehd.critic.body.backward")


def read(summary):
    if summary["span_kernel_s"].get(SPANS[1], 0.0) <= 0:
        return None
    return span_ms(summary, SPANS)
