"""k1_roofline: K1's (csrc/trace_fwd.cu) least time a frame over its
device time a frame, in %.  The least time is the larger of FWD_OPS
operations at the fp32 peak and bytes (tables and pixels, each once) at
the memory rate, counted over the reference's masks of the run's scene;
the card's power limit is printed beside it."""

from benchmark import roofline
from benchmark.trace import K1


def read(view):
    s = view.ranks[0]
    ns = view.kernel_ns(s, K1)
    if ns == 0:
        return None
    r = view.facts["config"]["render"]
    n_tbl = roofline.table_floats(view.facts["spheres"], view.facts["lights"])
    bound, _ = roofline.bound_s(view.work(), n_tbl, r["width"] * r["height"],
                                backward=False)
    return 100.0 * bound / (ns / s["steps"] / 1e9)
