"""allreduce_ms.train: the device time a step of the NCCL kernels (the
gradient's and the drop count's all-reduce), in ms; the mean over ranks.
An NCCL kernel runs from its launch until every rank has joined, so the
time holds the wait for the slowest rank's pixel block beside the
exchange itself.  None where no NCCL kernel ran (one rank, or gloo)."""

from benchmark.trace import nccl


def read(view):
    ms = view.mean_over_ranks(lambda s: view.per_step_ms(s, view.kernel_ns(s, nccl)))
    return ms or None
