"""frame_host_ms.frame: the host's time in render_sharded's body, in ms a
frame: total of the program's span render.frame / its count, from
raytpu_torch.utils.profiling's recorder, which holds the traced window
(rank 0's).  None where the program records no spans."""


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    frame = profiling.spans().get("render.frame", {"count": 0, "total_ns": 0})
    if frame["count"] == 0:
        return 0.0
    return frame["total_ns"] / frame["count"] / 1e6
