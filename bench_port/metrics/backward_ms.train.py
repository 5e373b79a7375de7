"""Device ms per step of the operations autograd launches for the
backward passes (inside its ``evaluate_function`` ranges, the
hand-written kernels of the renderer's backward included)."""


def read(summary):
    if summary["backward_kernel_s"] <= 0:
        return None
    return 1e3 * summary["backward_kernel_s"] / summary["iters"]
