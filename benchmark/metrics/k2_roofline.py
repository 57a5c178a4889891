"""k2_roofline: K2's (csrc/trace_bwd.cu) least time a step over its
device time a step, in %.  The least time is the larger of FWD_OPS +
ADJ_OPS operations at the fp32 peak and bytes (tables and pixels, each
once) at the memory rate, counted over the reference's masks of the
fit's starting scene; the card's power limit is printed beside it."""

from benchmark import roofline
from benchmark.trace import K2


def read(view):
    s = view.ranks[0]
    ns = view.kernel_ns(s, K2)
    if ns == 0:
        return None
    r = view.facts["config"]["render"]
    work = view.work()
    n_tbl = roofline.table_floats(view.facts["spheres"], view.facts["lights"])
    bound, _ = roofline.bound_s(work, n_tbl, r["width"] * r["height"],
                                backward=True)
    return 100.0 * bound / (ns / s["steps"] / 1e9)
