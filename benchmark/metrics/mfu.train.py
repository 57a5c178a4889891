"""mfu.train: the whole training step's share of the card's fp32 peak, in
%: the dense tracer's operations of one forward and one backward
(FWD_OPS + ADJ_OPS over the reference's masks of the fit's starting
scene, summed over ranks) over the traced window's seconds a step times
the peak (times the ranks)."""

from benchmark import roofline


def read(view):
    s = view.ranks[0]
    seconds = s["window_ns"] / s["steps"] / 1e9
    ops = roofline.operations(view.work(), backward=True)
    return 100.0 * ops / (seconds * roofline.PEAK_FP32 * len(view.ranks))
