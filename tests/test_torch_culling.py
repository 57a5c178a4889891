"""raytpu_torch.kernels.culling against raytpu.kernels.culling on the CPU.

Every function equals raytpu's exactly on the same seeded inputs (keys,
masks, packed tables and counts; tile_bounds and scene_bounds bit for bit:
the float32 interval arithmetic is raytpu's op for op), and the port passes
its own versions of tests/test_culling.py's five properties: a sphere
marked dead for a tile can never be hit (beam mask) or occlude (segment
mask) by any ray within the tile's bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu.kernels.culling as jcull
import raytpu_torch.scene as tscene
from raytpu_torch.kernels import culling
from raytpu_torch.kernels.trace_cuda import scene_tables

torch.set_num_threads(2)


def _ray_hits_sphere(o, d, c, r):
    """Reference hit test (raySphere semantics, eps root cutoff)."""
    p = o - c
    a = d @ d
    b = 2.0 * (d @ p)
    cc = p @ p - r * r
    rad = b * b - 4 * a * cc
    if rad < 0:
        return False
    root = np.sqrt(rad)
    return any(u > 1e-5 for u in ((-b + root) / (2 * a), (-b - root) / (2 * a)))


def _random_tiles(rng, n_tiles, rays_per_tile, coherent=True, targets=None):
    """Tiles of rays with tunable coherence (tight boxes exercise culling;
    loose boxes exercise conservativeness).  With `targets` (M, 3), half
    the tiles aim at a random target so hits occur."""
    origins, dirs = [], []
    for t in range(n_tiles):
        o0 = rng.uniform(-40, 40, 3)
        if targets is not None and t % 2 == 0:
            d0 = targets[rng.integers(len(targets))] - o0
        else:
            d0 = rng.normal(size=3)
        d0 /= np.linalg.norm(d0)
        o_spread = 10 ** rng.uniform(-2, 1 if coherent else 2)
        d_spread = 10 ** rng.uniform(-3, -0.5 if coherent else 0.5)
        origins.append(o0 + rng.uniform(-o_spread, o_spread, (rays_per_tile, 3)))
        dirs.append(d0 + rng.uniform(-d_spread, d_spread, (rays_per_tile, 3)))
    return np.asarray(origins, np.float32), np.asarray(dirs, np.float32)


def _fields(*arrays):
    """Each (tiles, rays, 3) array's x, y, z as flat numpy fields."""
    return [a[..., i].reshape(-1) for a in arrays for i in range(3)]


def _port(fields):
    return [torch.from_numpy(f) for f in fields]


def _raytpu(fields):
    return [jnp.asarray(f) for f in fields]


def _np(bounds):
    return [(np.asarray(lo), np.asarray(hi)) for lo, hi in bounds]


def _case(seed, coherent):
    """Seeded tiles and spheres, enough (tile, sphere) pairs (131,072) that
    some lie close to each test's boundary: (origins, directions, pos, rad,
    rays a tile)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-45, 45, (256, 3)).astype(np.float32)
    rad = rng.uniform(0.3, 6.0, 256).astype(np.float32)
    o, d = _random_tiles(rng, 512, 8, coherent=coherent, targets=pos)
    return o, d, pos, rad, 8


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _boundary_case(seed):
    """One-ray tiles (point boxes) where the beam test turns on the last
    bits of its float32 arithmetic: origins on a sphere's surface looking
    away (the sign of c), and origins outside on lines tangent to it (b^2
    against 4ac), each moved by a relative 1e-6 or less."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-45, 45, (64, 3))
    rad = rng.uniform(0.3, 6.0, 64)
    n = 2048
    i = rng.integers(64, size=n)
    u = _unit(rng.normal(size=(n, 3)))
    jitter = 1 + rng.uniform(-1e-6, 1e-6, (n, 1))
    o_surface = pos[i] + rad[i, None] * u * jitter
    d_away = u + rng.uniform(-1e-3, 1e-3, (n, 3))
    # Tangent lines: from distance D along u to the tangent point in a
    # random direction w perpendicular to u.
    w = _unit(np.cross(u, rng.normal(size=(n, 3))))
    k = rng.uniform(1.5, 4.0, (n, 1))
    r = rad[i, None]
    o_out = pos[i] + k * r * u
    touch = pos[i] + r * jitter * (u / k + np.sqrt(1 - 1 / k ** 2) * w)
    o = np.concatenate([o_surface, o_out]).astype(np.float32)
    d = np.concatenate([d_away, touch - o_out]).astype(np.float32)
    return o[:, None, :], d[:, None, :], pos.astype(np.float32), rad.astype(np.float32), 1


@pytest.mark.parametrize("case", ["coherent", "loose", "boundary"])
def test_tile_bounds_and_beam_mask_equal_raytpus(case):
    o, d, pos, rad, rpt = (_boundary_case(12) if case == "boundary"
                           else _case(10, case == "coherent"))
    fields = _fields(o, d)
    got = culling.tile_bounds(_port(fields), rpt)
    want = jcull.tile_bounds(_raytpu(fields), rpt)
    for (glo, ghi), (wlo, whi) in zip(_np(got), _np(want)):
        np.testing.assert_array_equal(glo, wlo)
        np.testing.assert_array_equal(ghi, whi)
    for inflate in (0.0, 0.05):
        live = culling.beam_live_mask(got, torch.from_numpy(pos),
                                      torch.from_numpy(rad), inflate)
        ref = jcull.beam_live_mask(want, jnp.asarray(pos), jnp.asarray(rad),
                                   inflate)
        assert live.dtype == torch.bool and live.shape == (o.shape[0], len(pos))
        np.testing.assert_array_equal(live.numpy(), np.asarray(ref))


def test_segment_mask_equals_raytpus():
    rng = np.random.default_rng(12)
    pts = (rng.uniform(-30, 30, (16, 1, 3))
           + rng.uniform(-3, 3, (16, 16, 3))).astype(np.float32)
    pos = rng.uniform(-45, 45, (32, 3)).astype(np.float32)
    rad = rng.uniform(0.5, 6.0, 32).astype(np.float32)
    fields = _fields(pts)
    for light in rng.uniform(-60, 60, (3, 3)).astype(np.float32):
        for inflate in (0.0, 0.05):
            live = culling.segment_hull_live_mask(
                culling.tile_bounds(_port(fields), 16), torch.from_numpy(light),
                torch.from_numpy(pos), torch.from_numpy(rad), inflate)
            ref = jcull.segment_hull_live_mask(
                jcull.tile_bounds(_raytpu(fields), 16), jnp.asarray(light),
                jnp.asarray(pos), jnp.asarray(rad), inflate)
            np.testing.assert_array_equal(live.numpy(), np.asarray(ref))


def test_keys_equal_raytpus():
    """scene_bounds, direction_octant, spatial_cell and bin_key on seeded
    rays, origins inside and outside the bounds (clamped cells)."""
    rng = np.random.default_rng(13)
    pos = rng.uniform(-20, 20, (30, 3)).astype(np.float32)
    rad = rng.uniform(0.5, 3.0, 30).astype(np.float32)
    lo, span = culling.scene_bounds(torch.from_numpy(pos), torch.from_numpy(rad))
    want_lo, want_span = jcull.scene_bounds(pos, rad)
    assert lo.dtype == span.dtype == np.float32
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(span, want_span)
    o = rng.uniform(-40, 40, (3, 4096)).astype(np.float32)
    d = rng.standard_normal((3, 4096)).astype(np.float32)
    d[:, :8] = 0.0  # the sign of a zero component
    np.testing.assert_array_equal(
        culling.direction_octant(*map(torch.from_numpy, d)).numpy(),
        np.asarray(jcull.direction_octant(*map(jnp.asarray, d))))
    np.testing.assert_array_equal(
        culling.spatial_cell(*map(torch.from_numpy, o), lo, span).numpy(),
        np.asarray(jcull.spatial_cell(*map(jnp.asarray, o), lo, span)))
    key = culling.bin_key(*map(torch.from_numpy, (*o, *d)), lo, span)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(
        key.numpy(), np.asarray(jcull.bin_key(*map(jnp.asarray, (*o, *d)), lo, span)))
    assert culling.N_CELLS == jcull.N_CELLS and culling.CELL_BITS == jcull.CELL_BITS


def test_pack_tile_scene_equals_raytpus():
    """A seeded mask over the port's own sphere table (scene_tables) and a
    seeded (4, N) table: tables and counts equal."""
    rng = np.random.default_rng(14)
    scene = tscene.random_scene(24, seed=5, device="cpu")
    for tbl in (scene_tables(scene)[0].numpy(),
                rng.standard_normal((4, 24)).astype(np.float32)):
        live = rng.random((7, 24)) < 0.3
        live[0] = False
        live[1] = True
        got, counts = culling.pack_tile_scene(torch.from_numpy(live),
                                              torch.from_numpy(tbl))
        want, want_counts = jcull.pack_tile_scene(jnp.asarray(live), jnp.asarray(tbl))
        assert counts.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


# tests/test_culling.py's five properties, on the port.

def test_beam_mask_conservative():
    rng = np.random.default_rng(0)
    n_tiles, rpt, n_sph = 24, 16, 40
    pos = rng.uniform(-45, 45, (n_sph, 3)).astype(np.float32)
    rad = rng.uniform(0.3, 6.0, n_sph).astype(np.float32)
    o, d = _random_tiles(rng, n_tiles, rpt, targets=pos)
    live = culling.beam_live_mask(culling.tile_bounds(_port(_fields(o, d)), rpt),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(rad)).numpy()
    assert live.shape == (n_tiles, n_sph)
    n_hits = 0
    for t in range(n_tiles):
        for s in range(n_sph):
            if any(_ray_hits_sphere(o[t, i], d[t, i], pos[s], rad[s])
                   for i in range(rpt)):
                n_hits += 1
                assert live[t, s], f"tile {t} can hit sphere {s} but culling killed it"
    assert n_hits > 10  # the test exercised hits


def test_beam_mask_culls_something():
    """Coherent tiles in a sparse scene kill most pairs."""
    rng = np.random.default_rng(1)
    o, d = _random_tiles(rng, 16, 16, coherent=True)
    pos = rng.uniform(-45, 45, (64, 3)).astype(np.float32)
    rad = rng.uniform(0.3, 2.0, 64).astype(np.float32)
    live = culling.beam_live_mask(culling.tile_bounds(_port(_fields(o, d)), 16),
                                  torch.from_numpy(pos), torch.from_numpy(rad))
    assert live.float().mean() < 0.5


def test_segment_mask_conservative():
    rng = np.random.default_rng(2)
    n_tiles, ppt, n_sph = 16, 16, 32
    pts = (rng.uniform(-30, 30, (n_tiles, 1, 3))
           + rng.uniform(-3, 3, (n_tiles, ppt, 3))).astype(np.float32)
    light = rng.uniform(-60, 60, 3).astype(np.float32)
    pos = rng.uniform(-45, 45, (n_sph, 3)).astype(np.float32)
    rad = rng.uniform(0.5, 6.0, n_sph).astype(np.float32)
    live = culling.segment_hull_live_mask(
        culling.tile_bounds(_port(_fields(pts)), ppt), torch.from_numpy(light),
        torch.from_numpy(pos), torch.from_numpy(rad)).numpy()

    def seg_hits(p, l, c, r):
        # the closest point of segment [p, l] to c within distance r?
        v = l - p
        t = np.clip(np.dot(c - p, v) / np.dot(v, v), 0.0, 1.0)
        return np.linalg.norm(p + t * v - c) <= r

    n_hits = 0
    for t in range(n_tiles):
        for s in range(n_sph):
            if any(seg_hits(pts[t, i], light, pos[s], rad[s]) for i in range(ppt)):
                n_hits += 1
                assert live[t, s]
    assert n_hits > 5


def test_pack_tile_scene_stable_prefix():
    rng = np.random.default_rng(3)
    tiles, n, rows = 5, 12, 4
    live = rng.random((tiles, n)) < 0.4
    tbl = rng.normal(size=(rows, n)).astype(np.float32)
    packed, counts = culling.pack_tile_scene(torch.from_numpy(live),
                                             torch.from_numpy(tbl))
    packed, counts = packed.numpy(), counts.numpy()
    assert packed.shape == (tiles, rows, n)
    for t in range(tiles):
        idx_live = np.flatnonzero(live[t])
        assert counts[t] == len(idx_live)
        # the live prefix in ascending sphere order (the tie-break holds)
        np.testing.assert_array_equal(packed[t, :, :counts[t]], tbl[:, idx_live])
        # the remainder is the dead spheres, also in order (a permutation)
        np.testing.assert_array_equal(packed[t, :, counts[t]:],
                                      tbl[:, np.flatnonzero(~live[t])])


def test_bin_key_groups_by_cell_and_octant():
    lo, span = culling.scene_bounds(np.array([[0.0, 0.0, 0.0], [8.0, 8.0, 8.0]]),
                                    np.array([1.0, 1.0]))
    ox = torch.tensor([0.0, 0.1, 8.0])
    zeros, ones = torch.zeros(3), torch.ones(3)
    k = culling.bin_key(ox, zeros, zeros, torch.tensor([1.0, 1.0, -1.0]), ones,
                        ones, lo, span).numpy()
    assert k[0] == k[1]          # same cell, same octant
    assert k[0] != k[2]          # different cell and octant
    assert (k >= 0).all() and (k < (1 << 12)).all()
