"""The port's recorder (raytpu_torch.utils.profiling): spans and counters
gated on the torch profiler, self time by thread, and the spans and
counters the program records on its step, frame, wrappers and wavefront.

Run on the CPU with the plain versions; no JAX is imported, so the file
also runs on a card with --noconftest."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytpu_torch import grad as tgrad
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import wavefront
from raytpu_torch.kernels.trace_cuda import TRACE_BWD, TRACE_FWD
from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL, WF_LEVEL_BWD,
                                            WF_UNCOMPACT, compact_torch,
                                            render_pixels_wavefront,
                                            wavefront_sizes)
from raytpu_torch.render import render_single
from raytpu_torch.scene import build_scene, default_scene, make_material
from raytpu_torch.utils import profiling
from raytpu_torch.utils.profiling import count, counters, reset, scoped, span, spans

torch.set_num_threads(2)

KERNELS = (TRACE_FWD, TRACE_BWD, WF_LEVEL, WF_COMPACT, WF_LEVEL_BWD, WF_UNCOMPACT)


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_recorder():
    reset()
    yield
    reset()


def test_the_gate_is_the_profilers_own_flag():
    """The recorder reads torch.autograd.profiler._is_profiler_enabled,
    which the profiler sets at its start and clears at its stop, as the
    benchmark starts and stops it: a span records between the two only."""
    assert profiling._PROFILER is torch.autograd.profiler
    assert torch.autograd.profiler._is_profiler_enabled is False
    prof = profiled()
    prof.start()
    assert torch.autograd.profiler._is_profiler_enabled is True
    with span("inside"):
        pass
    prof.stop()
    assert torch.autograd.profiler._is_profiler_enabled is False
    with span("after"):
        pass
    assert list(spans()) == ["inside"]


def test_nothing_is_recorded_outside_a_profiler():
    traced = scoped("f")(lambda x: x + 1)
    with span("outside"):
        count("n", 3)
        count("t", torch.tensor(4))
    assert traced(1) == 2
    assert spans() == {}
    assert not {"n", "t"} & set(counters())


def test_a_span_records_count_total_and_self():
    with profiled() as prof:
        for _ in range(2):
            with span("outer"):
                time.sleep(0.002)
                with span("inner"):
                    time.sleep(0.003)
    got = spans()
    assert set(got) == {"outer", "inner"}
    outer, inner = got["outer"], got["inner"]
    assert outer["count"] == 2 and inner["count"] == 2
    assert inner["self_ns"] == inner["total_ns"] >= 2 * 3_000_000
    assert outer["self_ns"] == outer["total_ns"] - inner["total_ns"]
    assert outer["self_ns"] >= 2 * 2_000_000
    # Each span also lies in the profiler's trace by its name.
    names = [e.name for e in prof.events()]
    assert names.count("outer") == 2 and names.count("inner") == 2


def test_a_span_on_another_thread_is_no_child_of_the_main_threads():
    def worker():
        with span("worker"):
            time.sleep(0.003)

    with profiled():
        with span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    got = spans()
    assert got["worker"]["count"] == 1
    assert got["main"]["self_ns"] == got["main"]["total_ns"]
    assert got["main"]["total_ns"] >= got["worker"]["total_ns"]
    assert profiling._local.stack == []


def test_scoped_is_span_as_a_decorator():
    @scoped("named")
    def f(a, b=2):
        """doc"""
        return a * b

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert f(3) == 6
    assert spans() == {}
    with profiled():
        assert f(3, b=4) == 12
        assert f(1) == 2
    assert spans()["named"]["count"] == 2


def test_counters_sum_host_ints_and_device_tensors(monkeypatch):
    """A 0-d tensor is kept and summed when read; past HELD_TENSORS a
    counter folds its tensors into one, to the same sum."""
    monkeypatch.setattr(profiling, "HELD_TENSORS", 3)
    with profiled():
        count("rays", 5)
        for v in range(1, 8):
            count("rays", torch.tensor(v, dtype=torch.int64))
        count("once")
    got = counters()
    assert got["rays"] == 5 + sum(range(1, 8)) and got["once"] == 1
    assert len(profiling._counts["rays"][1]) < 3


def test_counters_carry_the_kernels_launches_and_load(monkeypatch):
    for i, kernel in enumerate(KERNELS):
        monkeypatch.setattr(kernel, "launches", 10 + i)
    got = counters()
    for i, kernel in enumerate(KERNELS):
        assert got[f"launches.{kernel.name}"] == 10 + i
    assert isinstance(got["kernel.load_s"], float) and got["kernel.load_s"] >= 0
    assert isinstance(got["kernel.builds"], int)


def test_reset_forgets_spans_and_counters_but_not_launches(monkeypatch):
    monkeypatch.setattr(TRACE_FWD, "launches", 7)
    with profiled():
        with span("s"):
            count("c", 2)
    assert spans() and counters()["c"] == 2
    reset()
    assert spans() == {}
    assert "c" not in counters() and counters()["launches.trace_fwd"] == 7


SMALL = RenderConfig(width=16, height=8, max_depth=2, alias_factor=1)


def test_fit_scene_records_its_step():
    """Three steps: a fit.step, fit.update and fit.readback each, the
    step's forward, backward and reduce inside step.grad, and two
    snapshots a step (the step's input and the callback's) and the last;
    the callback runs outside every span."""
    scene = default_scene(device="cpu")
    target = torch.rand(SMALL.num_pixels, 3, generator=torch.Generator().manual_seed(1))
    open_in_callback = []

    def callback(step, loss, snapshot):
        open_in_callback.append(list(profiling._local.stack))

    with profiled():
        tgrad.fit_scene(scene, SMALL, target * 1e-3, steps=3, callback=callback)
    got = spans()
    for name in ("fit.step", "fit.update", "fit.readback", "step.grad",
                 "step.forward", "step.backward", "step.reduce"):
        assert got[name]["count"] == 3, name
    assert got["fit.snapshot"]["count"] == 7
    assert open_in_callback == [[], [], []]
    step = got["fit.step"]
    inside = sum(got[n]["total_ns"] for n in ("fit.update", "fit.readback", "step.grad"))
    assert 0 < step["self_ns"] <= step["total_ns"] - inside
    assert "fit.reruns" not in counters()


def test_render_single_records_the_frame():
    with profiled():
        render_single(default_scene(device="cpu"), SMALL)
        render_single(default_scene(device="cpu"), SMALL)
    assert spans()["render.frame"]["count"] == 2


def _counting_compact(seen):
    def compact(children, pid, cap, n_slots, return_dst=False):
        out = compact_torch(children, pid, cap, n_slots, return_dst)
        seen.append(int(out[3]))
        return out
    return compact


@pytest.mark.parametrize("ad", [False, True], ids=["forward", "grad"])
@pytest.mark.parametrize("width", [64, 144], ids=["one_chunk", "two_chunks"])
def test_wavefront_counts_chunks_levels_slots_and_live_rays(monkeypatch, ad, width):
    """wf.chunk and wf.level count chunk forwards x levels: under autograd
    with more than one chunk each chunk but the last runs twice (the
    checkpoint re-runs its forward), as wf.ad_chunks and wf.recomputed
    count; wf.live counts the camera rays inside the window and every ray
    that the compaction kept, and wf.slots K3's slots."""
    cfg = RenderConfig(width=width, height=64, max_depth=2, alias_factor=1)
    chunk, ws, cap, n_chunks = wavefront_sizes(cfg, 8192, 2)
    assert n_chunks == (1 if width == 64 else 2)
    seen = []
    scene = default_scene(device="cpu")
    levels = cfg.max_depth + 1
    recomputed = range(n_chunks - 1) if ad else range(0)
    runs = n_chunks + len(recomputed)  # chunk forwards
    camera = cfg.num_pixels + sum(-(-(cfg.num_pixels - c) // n_chunks)
                                  for c in recomputed)
    if ad:
        monkeypatch.setattr(wavefront, "CompactFn", _CountingCompactFn)
        monkeypatch.setattr(_CountingCompactFn, "seen", seen)
        target = torch.zeros(cfg.num_pixels, 3)
        with profiled():
            tgrad.loss_and_grad_wavefront(scene, cfg, target, chunk_rays=8192,
                                          capacity_factor=2)
    else:
        monkeypatch.setattr(wavefront, "compact", _counting_compact(seen))
        with profiled():
            render_pixels_wavefront(scene, cfg, chunk_rays=8192, capacity_factor=2)
    got, counted = spans(), counters()
    assert got["wf.frame"]["count"] == 1
    assert got["wf.chunk"]["count"] == runs
    assert got["wf.level"]["count"] == runs * levels
    assert counted.get("wf.ad_chunks", 0) == (n_chunks if ad else 0)
    assert counted.get("wf.recomputed", 0) == len(recomputed)
    assert "wf.bvh" not in got  # built on a card only
    assert len(seen) == runs * cfg.max_depth
    assert counted["wf.live"] == camera + sum(seen)
    assert counted["wf.live"] <= counted["wf.slots"]
    # K3's slots: the chunk at level 0, then the compactions' capacities.
    assert counted["wf.slots"] == runs * (chunk + min(2 * chunk, cap) + cap)


class _CountingCompactFn(torch.autograd.Function):
    """CompactFn over compact_torch, each call's kept count noted."""
    seen: list = []

    @staticmethod
    def forward(ctx, children, pid, cap, n_slots):
        state, out_pid, dropped, n_kept, dst = compact_torch(
            children, pid, cap, n_slots, return_dst=True)
        _CountingCompactFn.seen.append(int(n_kept))
        ctx.save_for_backward(dst)
        ctx.cap = cap
        ctx.mark_non_differentiable(out_pid, dropped, n_kept)
        return state, out_pid, dropped, n_kept

    @staticmethod
    def backward(ctx, d_state, *_):
        (dst,) = ctx.saved_tensors
        return wavefront.uncompact(d_state.contiguous(), dst, ctx.cap), None, None, None


def test_a_forced_drop_under_the_ladder_counts_a_rerun():
    """A frame-filling transparent sphere: every camera ray spawns two live
    children, so the ladder's first rung (capacity 8192 for 16384 live
    children) drops and the first step is re-run once at 1.25 (16384);
    the second step stays there."""
    mat = make_material(0.3, (0.2, 0.4, 0.6), (0.9, 0.9, 0.9), opacity=0.0, ior=1.5)
    scene = build_scene(sphere_specs=[((0.0, 0.0, -10.0), 9.9, mat)],
                        light_specs=[((10.0, 30.0, 10.0), (0.5, 0.5, 0.5))],
                        device="cpu")
    cfg = RenderConfig(width=128, height=64, max_depth=1, alias_factor=1)
    target = torch.zeros(cfg.num_pixels, 3)
    with profiled(), pytest.warns(RuntimeWarning, match="auto-capacity"):
        tgrad.fit_scene(scene, cfg, target, steps=2, backend="wavefront",
                        wf_opts=dict(chunk_rays=256))
    assert counters()["fit.reruns"] == 1
    assert spans()["fit.step"]["count"] == 2
    assert spans()["step.grad"]["count"] == 3


@pytest.fixture
def card():
    """The card the `cuda` tests run on; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_on_a_card_kernel_spans_and_device_counts(card, monkeypatch):
    """On a card: K2's wrapper runs on the autograd engine's device thread,
    so step.backward keeps all of its time as self time; the wavefront
    builds its BVH under wf.bvh and counts the compaction's kept rays as
    device tensors, summed to the live rays when read."""
    scene = default_scene(device=card)
    cfg = RenderConfig(width=64, height=48, max_depth=2, alias_factor=1)
    target = torch.zeros(cfg.num_pixels, 3, device=card)
    seen = []
    real = wavefront.compact

    def compact(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(int(out[3]))
        return out

    monkeypatch.setattr(wavefront, "compact", compact)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        tgrad.fit_scene(scene, cfg, target, steps=2, backend="cuda")
        render_pixels_wavefront(scene, cfg, chunk_rays=8192, capacity_factor=2)
    torch.cuda.synchronize(card)
    got = spans()
    for name in ("k1.launch", "k2.launch", "step.backward", "fit.step"):
        assert got[name]["count"] == 2, name
    assert got["step.backward"]["self_ns"] == got["step.backward"]["total_ns"]
    assert got["wf.bvh"]["count"] == 1 and got["wf.level"]["count"] == 3
    held = profiling._counts["wf.live"][1]
    assert held and all(t.device.type == "cuda" for t in held)
    counted = counters()
    assert counted["wf.live"] == cfg.num_pixels + sum(seen)
    assert counted["wf.live"] <= counted["wf.slots"]
