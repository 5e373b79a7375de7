"""Device ms per training step of the frozen critic, its forward and the
backward to its input (``shapehd.critic``, ``shapehd.critic.backward``),
the stem's included."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("shapehd.critic", "shapehd.critic.backward"))
