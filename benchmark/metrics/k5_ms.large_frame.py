"""k5_ms.large_frame: K5's (csrc/wf_compact.cu: the compaction's scan and
its tail) device time a frame, in ms, by kernel name, in the large-scene
frame cell; the mean over ranks.  None where no K5 ran."""

from benchmark.trace import K5


def read(view):
    ms = view.mean_over_ranks(lambda s: view.per_step_ms(s, view.kernel_ns(s, K5)))
    return ms or None
