"""mfu.frame: the whole frame's share of the card's fp32 peak, in %: the
dense tracer's forward operations (FWD_OPS over the reference's masks of
the run's scene, summed over ranks) over the traced window's seconds a
frame times the peak (times the ranks)."""

from benchmark import roofline


def read(view):
    s = view.ranks[0]
    seconds = s["window_ns"] / s["steps"] / 1e9
    ops = roofline.operations(view.work(), backward=False)
    return 100.0 * ops / (seconds * roofline.PEAK_FP32 * len(view.ranks))
