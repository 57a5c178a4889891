"""inplace_pct.train: the share of the wavefront's kernel slots that
ran on the instances reading the scene table in place from global memory,
in %: 100 x (wf.slots_inplace + wf.bwd_slots_inplace) / (wf.slots +
wf.bwd_slots), K3's slots and K4's over the traced window, from
raytpu_torch.utils.profiling's recorder (rank 0's).  None where the
program counts no K4 slots (a program without these counters)."""


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counters = profiling.counters()
    if "wf.bwd_slots" not in counters:
        return None
    slots = counters.get("wf.slots", 0) + counters["wf.bwd_slots"]
    if slots == 0:
        return 0.0
    return 100.0 * (counters.get("wf.slots_inplace", 0)
                    + counters.get("wf.bwd_slots_inplace", 0)) / slots
