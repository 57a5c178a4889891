"""launch_ms.train: the host's time in the dense kernels' wrappers, in ms
a step: the self time of the program's spans k1.launch, k2.launch and
scene.tables / count of fit.step, from raytpu_torch.utils.profiling's
recorder, which holds the traced window (rank 0's).  None where the
program records no spans."""

WRAPPERS = ("k1.launch", "k2.launch", "scene.tables")


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    steps = spans.get("fit.step", {"count": 0})["count"]
    if steps == 0:
        return 0.0
    ns = sum(spans.get(n, {"self_ns": 0})["self_ns"] for n in WRAPPERS)
    return ns / steps / 1e6
