"""k4_ms.train: K4's (csrc/wf_level_bwd.cu) device time a step, in ms, by
kernel name, in the fit cells judged by train_mrays_per_s; the mean over
ranks."""

from benchmark.trace import K4


def read(view):
    ms = view.mean_over_ranks(lambda s: view.per_step_ms(s, view.kernel_ns(s, K4)))
    return ms or None
