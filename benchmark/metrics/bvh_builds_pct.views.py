"""bvh_builds_pct.views: the wavefront's tree builds over the views
rendered, in %: 100 x the count of the program's span wf.bvh / its
counter views.rendered over the traced window, from
raytpu_torch.utils.profiling's recorder (rank 0's).  A step that builds
one tree for its V views reads 100 / V (12.5 with 8), one tree a view
100.  None where the program records no spans or renders no view (a
program without the multi-view step)."""


def read(view):
    from raytpu_torch.utils import profiling

    if not (hasattr(profiling, "spans") and hasattr(profiling, "counters")):
        return None
    rendered = profiling.counters().get("views.rendered", 0)
    if rendered == 0:
        return None
    builds = profiling.spans().get("wf.bvh", {"count": 0})["count"]
    return 100.0 * builds / rendered
