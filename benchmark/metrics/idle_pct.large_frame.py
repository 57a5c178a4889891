"""idle_pct.large_frame: the share of the traced window, in %, in which no
kernel, memcpy or memset runs on the device, in the large-scene frame
cell; the mean over ranks."""


def read(view):
    return view.mean_over_ranks(lambda s: 100.0 * (1 - s["busy_ns"] / s["window_ns"]))
