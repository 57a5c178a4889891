"""k4_ms: K4's (csrc/wf_level_bwd.cu) device time a step, in ms,
by kernel name; the mean over ranks."""

from benchmark.trace import K4


def read(view):
    ms = view.mean_over_ranks(lambda s: view.per_step_ms(s, view.kernel_ns(s, K4)))
    return ms or None
