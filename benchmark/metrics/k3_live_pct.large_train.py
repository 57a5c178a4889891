"""k3_live_pct.large_train: the share of K3's launched slots that hold a
live ray, in %: 100 x the program's counter wf.live / wf.slots over the
traced window (every level of every chunk, the checkpoint's recompute
included), from raytpu_torch.utils.profiling's recorder (rank 0's).
None where the program records no counters."""


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counters = profiling.counters()
    slots = counters.get("wf.slots", 0)
    if slots == 0:
        return 0.0
    return 100.0 * counters.get("wf.live", 0) / slots
