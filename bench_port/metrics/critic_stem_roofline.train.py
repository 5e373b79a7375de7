"""The critic stem's least time on the H100, forward and backward to its
input, at the step's shape (``cost/critic_stem.py``), over the device
time of the operations launched in ``shapehd.critic.stem`` and
``shapehd.critic.stem.backward``.  None where either span is missing."""

from cost import critic_stem

SPANS = ("shapehd.critic.stem", "shapehd.critic.stem.backward")


def read(summary):
    calls = summary.get("critic_stem_calls")
    spent = [summary["span_kernel_s"].get(n, 0.0) for n in SPANS]
    if not calls or min(spent) <= 0:
        return None
    least = sum(critic_stem.bound_s(*c) for c in calls) * summary["iters"]
    return 100.0 * least / sum(spent)
