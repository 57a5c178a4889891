"""update_ms.train: Adam's update in fit_scene's step (the gradient's
assignment and opt.step()), in ms a step: total of the program's span
fit.update / count of fit.step, from raytpu_torch.utils.profiling's
recorder, which holds the traced window (rank 0's).  None where the
program records no spans."""


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    steps = spans.get("fit.step", {"count": 0})["count"]
    if steps == 0:
        return 0.0
    return spans.get("fit.update", {"total_ns": 0})["total_ns"] / steps / 1e6
