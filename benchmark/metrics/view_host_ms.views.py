"""view_host_ms.views: the host's time to issue one view's forward and
backward, in ms: the mean of the program's span views.view (total over
count) over the traced window, from raytpu_torch.utils.profiling's
recorder (rank 0's).  The step reads nothing back inside a view, so the
span waits for the device only where the launch queue is full.  None
where the program records no such span."""


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    span = profiling.spans().get("views.view", {"count": 0})
    if span["count"] == 0:
        return None
    return span["total_ns"] / span["count"] / 1e6
