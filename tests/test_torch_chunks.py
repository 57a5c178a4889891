"""The wavefront's chunk loop on the CPU: `streams` and per-chunk
rematerialisation under autograd, against raytpu's scan over trace_stream.

Chunks align to lcm(8192, spp) camera rays, so every multi-chunk frame
here has more than 8192 camera rays.  What is held, and how closely:

  * `streams` 1, 2 and 3 give the same frame bit for bit and the same drop
    count, over the full frame, a strided window with a clamped tail, and
    a frame that drops rays;
  * `streams=2` gives raytpu's `streams=2` frame (its Pallas interpreter)
    under tests/test_wavefront.py:25-36's contract, both dropping nothing;
  * the gradient of a 3-chunk frame, whose chunks but the last are
    checkpointed (K3's and K5's plain versions run twice a chunk but the
    last), against raytpu's jax.vjp of its jnp tracer
    (tests/test_torch_wavefront_grad.py's masked cotangent, every leaf
    within 2e-3 x scale) and against the port's eager autograd (loss rtol
    1e-5, the same leaf bound);
  * autograd holds one chunk's per-level residuals, the last chunk's:
    outside the checkpoints it saves those, the scene tables once a
    checkpointed chunk and frame-sized buffers only;
  * the backward runs the last chunk's level backwards before it re-runs
    any other chunk's forward, so the peak holds one chunk's residuals;
  * the recorder counts a differentiable frame's chunks (wf.ad_chunks) and
    those checkpointed (wf.recomputed), once each, in the forward;
  * a drop is counted once: the step's count is the forward's, and
    fit_scene's ladder climbs on it.
"""

import numpy as np
import pytest
import torch
from test_torch_wavefront import assert_wavefront_contract, overflow_scenes
from test_torch_wavefront_grad import assert_leaf_within, masked_gradient_case
from torch.profiler import ProfilerActivity, profile

import raytpu.config as jconfig
import raytpu.scene as jscene
import raytpu_torch.config as tconfig
import raytpu_torch.grad as tgrad
import raytpu_torch.scene as tscene
from raytpu.kernels.wavefront import render_pixels_wavefront as j_render_pixels_wavefront
from raytpu_torch.kernels import wavefront
from raytpu_torch.kernels.trace_cuda import scene_tables
from raytpu_torch.kernels.wavefront import render_pixels_wavefront, wavefront_sizes
from raytpu_torch.scene import LEAF_NAMES, scene_from_leaves, scene_leaves
from raytpu_torch.utils.profiling import counters, reset

torch.set_num_threads(2)

CHUNK = 8192
# (scene, frame, window, capacity): 3 chunks each.  The window's strided
# pixels run past the frame, so its tail clamps to pixel P-1; the
# overflow scene at capacity 1 drops live rays in every chunk.
STREAM_CASES = {
    "frame": ("random24", dict(width=160, height=120, max_depth=2), {}, 2),
    "window": ("random24", dict(width=200, height=150, max_depth=2),
               dict(offset=1, count=17000, shard_stride=2), 2),
    "drops": ("overflow", dict(width=128, height=192, max_depth=2), {}, 1),
}


def port_scene(name):
    if name == "overflow":
        return overflow_scenes()[1]
    return tscene.random_scene(24, num_lights=2, seed=5, device="cpu")


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streams_give_the_same_frame(case):
    name, frame, window, factor = STREAM_CASES[case]
    cfg = tconfig.RenderConfig(alias_factor=1, **frame)
    assert wavefront_sizes(cfg, CHUNK, factor, window.get("count"))[3] == 3
    scene = port_scene(name)
    frames, drops = [], []
    for streams in (1, 2, 3):
        img, info = render_pixels_wavefront(scene, cfg, chunk_rays=CHUNK,
                                            capacity_factor=factor,
                                            return_info=True, streams=streams,
                                            **window)
        frames.append(img)
        drops.append(int(info["dropped"]))
    assert all(torch.equal(frames[0], f) for f in frames[1:])
    assert drops == [drops[0]] * 3
    assert (drops[0] > 0) == (case == "drops")
    with pytest.raises(ValueError, match="streams"):
        render_pixels_wavefront(scene, cfg, chunk_rays=CHUNK, streams=0)


def test_streams_match_raytpu_streams():
    """3 chunks on 2 streams: raytpu scans 2 steps of 2 chunks, its fourth
    a padded tail; the port launches the 3 real chunks."""
    kw = dict(width=160, height=120, max_depth=2, alias_factor=1)
    tcfg = tconfig.RenderConfig(**kw)
    assert wavefront_sizes(tcfg, CHUNK, 2)[3] == 3
    want, jinfo = j_render_pixels_wavefront(
        jscene.default_scene(), jconfig.RenderConfig(**kw), chunk_rays=CHUNK,
        streams=2, interpret=True, return_info=True)
    got, info = render_pixels_wavefront(tscene.default_scene(device="cpu"), tcfg,
                                        chunk_rays=CHUNK, streams=2,
                                        return_info=True)
    assert int(info["dropped"]) == int(jinfo["dropped"]) == 0
    assert_wavefront_contract(got.numpy(), np.asarray(want))


def counting(monkeypatch, name):
    """Count the calls of wavefront's module function `name`."""
    calls = []
    real = getattr(wavefront, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(wavefront, name, spy)
    return calls


# Pixels of the 160x120 depth-2 default-scene frame whose forwards differ
# between the port and raytpu's jax.vjp program by more than 1e-5*scale:
# measured on x86-64, bound +25%.
GRAD_BAD = 161  # 129


def test_gradient_over_three_checkpointed_chunks(monkeypatch):
    kw = dict(width=160, height=120, max_depth=2, alias_factor=1)
    jcfg, tcfg = jconfig.RenderConfig(**kw), tconfig.RenderConfig(**kw)
    chunks = wavefront_sizes(tcfg, CHUNK, 2)[3]
    assert chunks == 3
    levels = tcfg.max_depth + 1
    js, ts = jscene.default_scene(), tscene.default_scene(device="cpu")
    level_calls, compact_calls = (counting(monkeypatch, "wf_level"),
                                  counting(monkeypatch, "compact"))
    # masked_gradient_case asks for 1024-ray chunks: 8192 after alignment.
    got, want = masked_gradient_case(js, ts, jcfg, tcfg, max_bad=GRAD_BAD)
    # The backward re-ran every chunk's forward but the last's.
    assert len(level_calls) == (2 * chunks - 1) * levels
    assert len(compact_calls) == (2 * chunks - 1) * (levels - 1)
    for name, a, w in zip(LEAF_NAMES, got, want):
        assert_leaf_within(name, np.zeros(np.shape(w)) if a is None else a, w)

    target = torch.full((tcfg.num_pixels, 3), 1e-4)
    lw, gw, info = tgrad.loss_and_grad_wavefront(ts, tcfg, target, chunk_rays=CHUNK,
                                                 return_info=True)
    lp, gp = tgrad.loss_and_grad(ts, tcfg, target, backend="torch")
    assert info["dropped"] == 0
    np.testing.assert_allclose(float(lw), float(lp), rtol=1e-5)
    for name, a, b in zip(LEAF_NAMES, scene_leaves(gw), scene_leaves(gp)):
        assert_leaf_within(name, a, b)


def saved_outside_checkpoints(scene, cfg):
    """The (shape, bytes) of every tensor autograd saves for the MSE of the
    wavefront frame, as an outer saved_tensors_hooks sees them: a
    checkpointed chunk's own saves go to the checkpoint's hooks."""
    leaves = [t.detach().requires_grad_(True) for t in scene_leaves(scene)]
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.numel() * t.element_size()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        img = render_pixels_wavefront(scene_from_leaves(leaves), cfg, chunk_rays=CHUNK)
        loss = torch.mean((img - 1e-4) ** 2)
    torch.autograd.grad(loss, leaves, allow_unused=True)
    return saved


def test_no_chunk_residuals_are_kept():
    """No chunk's residuals but the last's: outside the checkpoints autograd
    saves the frame-sized buffers, the tables once a checkpointed chunk
    (its inputs) and the last chunk's level residuals, the same bytes and
    shapes whatever the number of chunks before it."""
    scene = tscene.random_scene(24, num_lights=2, seed=5, device="cpu")
    tables = [(tuple(t.shape), t.numel() * t.element_size())
              for t in scene_tables(scene)]
    tables_bytes = sum(b for _, b in tables)
    rest, shapes = {}, {}
    for height in (48, 96, 144):  # 1, 2 and 3 chunks at the same width
        cfg = tconfig.RenderConfig(width=160, height=height, max_depth=2,
                                   alias_factor=1)
        chunks = wavefront_sizes(cfg, CHUNK, 2)[3]
        assert chunks == height // 48
        saved = saved_outside_checkpoints(scene, cfg)
        frame = sum(b for shape, b in saved if shape[0] == cfg.num_pixels)
        total = sum(b for _, b in saved)
        rest[chunks] = (total, frame)
        shapes[chunks] = sorted(s for s, _ in saved if s[0] != cfg.num_pixels)
    # One chunk is not checkpointed: its level residuals are there for the
    # hooks to see, at least the camera state, 10 floats a ray.
    kept = rest[1][0] - rest[1][1]
    assert kept >= 40 * CHUNK
    for chunks in (2, 3):
        # The checkpoints' inputs (the tables, once a checkpointed chunk)
        # and the last chunk's residuals, as a frame of one chunk keeps.
        assert rest[chunks][0] - rest[chunks][1] - (chunks - 1) * tables_bytes == kept
        assert shapes[chunks] == sorted(shapes[1] + (chunks - 1) * [s for s, _ in tables])
    # A third chunk adds its pixels' frame-sized buffers and the tables.
    assert (rest[3][0] - rest[2][0]
            == rest[3][1] - rest[2][1] + tables_bytes)


def test_the_last_chunk_runs_its_backward_before_any_recompute(monkeypatch):
    """The backward of a 3-chunk frame: the last chunk's level backwards,
    from its kept residuals, run before any other chunk's forward is re-run,
    and each checkpointed chunk then re-runs its forward and runs its
    backward in turn, the latest first.  So no two chunks' residuals are
    live at once."""
    cfg = tconfig.RenderConfig(width=160, height=144, max_depth=2,
                               alias_factor=1)
    chunks = wavefront_sizes(cfg, CHUNK, 2)[3]
    assert chunks == 3
    levels = cfg.max_depth + 1
    log = []

    def log_calls(name, entry):
        real = getattr(wavefront, name)

        def spy(*args, **kwargs):
            log.append(entry(args))
            return real(*args, **kwargs)

        monkeypatch.setattr(wavefront, name, spy)

    log_calls("chunk_camera_state", lambda args: ("chunk", args[3]))
    log_calls("wf_level", lambda args: "K3")
    log_calls("wf_level_bwd", lambda args: "K4")
    scene = tscene.random_scene(24, num_lights=2, seed=5, device="cpu")
    leaves = [t.detach().requires_grad_(True) for t in scene_leaves(scene)]
    img = render_pixels_wavefront(scene_from_leaves(leaves), cfg, chunk_rays=CHUNK)
    forward = [e for c in range(chunks) for e in [("chunk", c)] + levels * ["K3"]]
    assert log == forward
    torch.autograd.grad(torch.mean((img - 1e-4) ** 2), leaves, allow_unused=True)
    backward = levels * ["K4"] + [
        e for c in reversed(range(chunks - 1))
        for e in [("chunk", c)] + levels * ["K3"] + levels * ["K4"]]
    assert log[len(forward):] == backward


def test_the_recomputed_chunks_are_counted():
    """While a profiler records, a differentiable frame adds its chunks to
    wf.ad_chunks and its checkpointed chunks to wf.recomputed, once in the
    forward (a recompute adds nothing); a frame without grad adds to
    neither, nor does a frame outside a profiler."""
    scene = tscene.random_scene(24, num_lights=2, seed=5, device="cpu")
    leaves = [t.detach().requires_grad_(True) for t in scene_leaves(scene)]

    def frame(height, grad=True):
        cfg = tconfig.RenderConfig(width=160, height=height, max_depth=1,
                                   alias_factor=1)
        with torch.set_grad_enabled(grad):
            img = render_pixels_wavefront(scene_from_leaves(leaves), cfg,
                                          chunk_rays=CHUNK)
        if grad:
            torch.autograd.grad(img.sum(), leaves, allow_unused=True)
        return {k: counters().get(k, 0) for k in ("wf.ad_chunks", "wf.recomputed")}

    reset()
    try:
        assert frame(144) == {"wf.ad_chunks": 0, "wf.recomputed": 0}
        with profile(activities=[ProfilerActivity.CPU]):
            assert frame(144, grad=False) == {"wf.ad_chunks": 0, "wf.recomputed": 0}
            assert frame(144) == {"wf.ad_chunks": 3, "wf.recomputed": 2}
            reset()
            assert frame(48) == {"wf.ad_chunks": 1, "wf.recomputed": 0}
            assert frame(48, grad=False) == {"wf.ad_chunks": 1, "wf.recomputed": 0}
    finally:
        reset()


def test_a_drop_is_counted_once():
    """The overflow scene over 3 chunks: the checkpointed step's drop count
    is the forward's (a recompute adds nothing), and fit_scene's ladder
    warns with that count at the rung that drops."""
    _, ts = overflow_scenes()
    cfg = tconfig.RenderConfig(width=128, height=192, max_depth=1, alias_factor=1)
    assert wavefront_sizes(cfg, CHUNK, 1)[3] == 3
    target = torch.zeros(cfg.num_pixels, 3)
    with torch.no_grad():
        _, fwd = render_pixels_wavefront(ts, cfg, chunk_rays=CHUNK,
                                         capacity_factor=1, return_info=True)
    n = int(fwd["dropped"])
    assert n > 0
    _, _, info = tgrad.loss_and_grad_wavefront(ts, cfg, target, chunk_rays=CHUNK,
                                               capacity_factor=1, on_drop="ignore",
                                               return_info=True)
    assert info["dropped"] == n
    with pytest.warns(RuntimeWarning, match="auto-capacity") as warned:
        _, losses = tgrad.fit_scene(ts, cfg, target, steps=1, backend="wavefront",
                                    wf_opts=dict(chunk_rays=CHUNK, streams=2),
                                    optimizer=lambda p: torch.optim.SGD(p, lr=1.0))
    assert str(warned[0].message).startswith(f"wavefront auto-capacity: {n} live")
    loss, _, info = tgrad.loss_and_grad_wavefront(ts, cfg, target, chunk_rays=CHUNK,
                                                  capacity_factor=2.0,
                                                  return_info=True)
    assert info["dropped"] == 0 and losses == [float(loss)]
