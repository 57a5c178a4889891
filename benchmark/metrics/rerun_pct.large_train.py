"""rerun_pct.large_train: the capacity ladder's discarded steps, in % of
fit steps: 100 x the program's counter fit.reruns / count of the span
fit.step over the traced window, from raytpu_torch.utils.profiling's
recorder (rank 0's).  None where the program records neither."""


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    steps = profiling.spans().get("fit.step", {"count": 0})["count"]
    if steps == 0:
        return 0.0
    return 100.0 * profiling.counters().get("fit.reruns", 0) / steps
