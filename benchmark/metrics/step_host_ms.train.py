"""step_host_ms.train: the host's time in fit_scene's step less its loss
read-back, in ms a step: (total of the program's span fit.step - total of
fit.readback) / count of fit.step, from raytpu_torch.utils.profiling's
recorder, which holds the traced window (rank 0's).  None where the
program records no spans."""


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    step = spans.get("fit.step", {"count": 0, "total_ns": 0})
    readback = spans.get("fit.readback", {"total_ns": 0})
    if step["count"] == 0:
        return 0.0
    return (step["total_ns"] - readback["total_ns"]) / step["count"] / 1e6
