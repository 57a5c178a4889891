"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and each fault the cells can have,
planted under a whole run of the harness on the CPU, read as not correct
under the cells' own limits."""

from __future__ import annotations

import pytest
import torch

from benchmark import compare, control, harness

TRAIN = ["tiny-train", "tiny-wavefront"]


@pytest.mark.parametrize("cell", TRAIN + ["tiny-frame"])
def test_control_fails(tiny_root, cell):
    found = harness.find_cell(tiny_root, cell)
    read = control.training if cell in TRAIN else control.frame
    got = read(found, 2 ** 31 + 21, torch.device("cpu"), variants=("control",))
    assert not compare.judge(got["control"], found["limits"]), got


def run_broken(root, cell, seed=2 ** 31 + 23):
    from test_benchmark_rehearsal import rehearse

    _, (res, _) = rehearse(root, cell, seed=seed, seconds=0.1)
    return res


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_fails(tiny_root, cell, monkeypatch):
    import raytpu_torch.grad as grad
    from raytpu_torch.scene import scene_from_leaves, scene_leaves

    real = grad.loss_and_grad_sharded

    def unchanged(*args, **kw):
        loss, g, *info = real(*args, **kw)
        zero = scene_from_leaves([torch.zeros_like(t) for t in scene_leaves(g)])
        return (loss, zero, *info)

    monkeypatch.setattr(grad, "loss_and_grad_sharded", unchanged)
    res = run_broken(tiny_root, cell)
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_fails(tiny_root, cell, monkeypatch):
    """Each step's loss is the mean over the first half of the pixels
    only."""
    import raytpu_torch.grad as grad

    def half(scene, cfg, target_flat, mesh=None, backend="auto",
             interleave=False, wf_opts=None, on_drop="raise",
             return_info=False):
        n = cfg.num_pixels // 2
        info = {}

        def loss(s):
            err = grad._render_ad(s, cfg, None, backend, wf_opts, info,
                                  (0, n, 1)) - target_flat[:n]
            return torch.sum(err * err) / (3 * n)

        value, g = grad._value_and_grad(loss, scene)
        return (value, g, {"dropped": 0}) if return_info else (value, g)

    monkeypatch.setattr(grad, "loss_and_grad_sharded", half)
    res = run_broken(tiny_root, cell)
    assert res["correct"] is False, res["check"]


def test_an_altered_frame_fails(tiny_root, monkeypatch):
    """The frame's middle row is altered where the frame is produced, as
    control.py's "altered" alters the reference's."""
    import raytpu_torch.render as render

    real = render.render_single

    def altered(scene, cfg, *args, **kw):
        img = real(scene, cfg, *args, **kw).clone()
        img[img.shape[0] // 2] += 0.1 * img.abs().max()
        return img

    monkeypatch.setattr(render, "render_single", altered)
    res = run_broken(tiny_root, "tiny-frame")
    assert res["correct"] is False, res["check"]


def _sharded_rank(rank, world, url, root, cell, broken, out):
    import time
    from pathlib import Path

    import raytpu_torch.grad as grad

    if broken:  # every rank keeps its own share: the exchange left out
        grad.all_reduce_sum = lambda mesh, t: t
    found = harness.find_cell(Path(root), cell)
    args = harness.parse(["--workload", cell, "--seed", str(2 ** 31 + 29),
                          "--seconds", "0.1"])
    args.init = url
    res = harness.run_rank(found, args, rank, world, torch.device("cpu"),
                           time.perf_counter())
    if rank == 0:
        Path(out).write_text(__import__("json").dumps(res[0]))


@pytest.mark.parametrize("broken", [False, True])
def test_the_exchange_left_out_fails(tiny_root, tmp_path, broken):
    """The sharded cell over two gloo ranks: correct, and with the
    all-reduce of the step's gradient and loss left out, not correct."""
    import json
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        url = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    out = tmp_path / "line.json"
    mp.spawn(_sharded_rank, args=(2, url, str(tiny_root), "tiny-sharded", broken,
                                  str(out)), nprocs=2)
    res = json.loads(out.read_text())
    assert res["correct"] is (not broken), res["check"]
    assert res["device"]["count"] == 2
