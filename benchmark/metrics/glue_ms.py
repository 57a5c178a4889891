"""glue_ms: the device time a step in every kernel that is neither one of
the program's six (K1-K6) nor NCCL's, in ms: the wavefront's
orchestration (index_add_, concatenations, camera state), the BVH build
and the optimizer's kernels; the mean over ranks."""

from benchmark.trace import K1, K2, K3, K4, K5, K6, nccl

OURS = (K1, K2, K3, K4, K5, K6)


def read(view):
    def glue(k):
        return not nccl(k) and not any(m(k) for m in OURS)
    return view.mean_over_ranks(lambda s: view.per_step_ms(s, view.kernel_ns(s, glue)))
