"""Per cent of the traced stretch in which the device ran nothing: 1 -
the union of its operations' intervals over the stretch's host-clock
length."""

from metrics._read import idle_share


def read(summary):
    return idle_share(summary)
