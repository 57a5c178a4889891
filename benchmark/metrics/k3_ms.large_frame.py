"""k3_ms.large_frame: K3's (csrc/wf_level.cu with bvh.cuh) device time a
frame, in ms, by kernel name, in the large-scene frame cell; the mean over
ranks.  None where no K3 ran."""

from benchmark.trace import K3


def read(view):
    ms = view.mean_over_ranks(lambda s: view.per_step_ms(s, view.kernel_ns(s, K3)))
    return ms or None
