"""The port's algebra, geometry and shading ops against raytpu.ops on
seeded inputs.

Both sides run op by op (eager jnp against eager torch), so they differ
only by rounding: jax.lax.rsqrt is not correctly rounded (up to 2 ulp)
where the port takes 1/sqrt.  The tolerance is rtol 1e-5 with an absolute
floor of 1e-6 on unit-scale values (1e-10 on light sums, which are ~1e-4).
Discrete outputs (hit flags, sphere indices, root counts) must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu.ops.algebra as jalg
import raytpu.ops.geometry as jgeo
import raytpu.ops.shading as jsh
import raytpu.scene as jscene
import raytpu_torch.ops.algebra as talg
import raytpu_torch.ops.geometry as tgeo
import raytpu_torch.ops.shading as tsh
import raytpu_torch.scene as tscene

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=atol)


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def t(x):
    return torch.tensor(np.asarray(x))


def scenes(n=12, seed=5):
    return jscene.random_scene(n, seed=seed), tscene.random_scene(n, seed=seed, device="cpu")


def rays(n=512, seed=0):
    """Rays from near the camera towards the random scene's half space."""
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origin, d.astype(np.float32)


def test_solve_quadratic_all_branches():
    rng = np.random.default_rng(1)
    a = rng.uniform(-2, 2, 400).astype(np.float32)
    b = rng.uniform(-2, 2, 400).astype(np.float32)
    c = rng.uniform(-2, 2, 400).astype(np.float32)
    a[:40] = 0.0                 # linear branch
    a[40:60], b[40:60] = 0.0, 0.0  # no root
    c[60:100] = b[60:100] ** 2 / (4 * a[60:100])  # double root (within TOL)
    jr, jn = jalg.solve_quadratic(a, b, c)
    tr, tn = talg.solve_quadratic(t(a), t(b), t(c))
    equal(tn, jn)
    assert tn.dtype == torch.int32
    close(tr, jr)


def test_is_zero_and_safe_sqrt():
    x = np.array([-1e-3, -9e-4, 0.0, 5e-4, 1e-3, 2.0, -4.0], np.float32)
    equal(talg.is_zero(t(x)), jalg.is_zero(x))
    equal(talg.safe_sqrt(t(x)), jalg.safe_sqrt(x))


def test_normalize_and_dot3():
    v = np.random.default_rng(3).normal(size=(300, 3)).astype(np.float32)
    v[0] = 0.0
    close(tgeo.normalize(t(v)), jgeo.normalize(v))
    close(tgeo.dot3(t(v), t(v[::-1].copy())), jgeo.dot3(v, v[::-1]))


def test_ray_sphere_t_and_closest_hit():
    js, ts = scenes()
    o, d = rays()
    jt, jf = jgeo.ray_sphere_t(o, d, js.spheres.pos, js.spheres.radius)
    tt, tf = tgeo.ray_sphere_t(t(o), t(d), ts.spheres.pos, ts.spheres.radius)
    equal(tf, jf)
    close(tt, jt)
    jh = jgeo.closest_hit(o, d, js.spheres)
    th = tgeo.closest_hit(t(o), t(d), ts.spheres)
    assert 0 < int(np.asarray(jh.found).sum()) < len(o)
    equal(th.found, jh.found)
    m = np.asarray(jh.found)
    equal(th.index.numpy()[m], np.asarray(jh.index)[m])
    for field in ("t", "point", "normal"):
        close(getattr(th, field), getattr(jh, field))


def test_primary_container():
    js, ts = scenes()
    rng = np.random.default_rng(4)
    centres = np.asarray(js.spheres.pos)
    p = (centres[rng.integers(0, len(centres), 600)]
         + rng.normal(scale=2.0, size=(600, 3))).astype(np.float32)
    got = tgeo.primary_container(t(p), ts.spheres)
    want = jgeo.primary_container(p, js.spheres)
    assert (np.asarray(want) >= 0).any() and (np.asarray(want) < 0).any()
    equal(got, want)


def _hits(js, o, d):
    h = jgeo.closest_hit(o, d, js.spheres)
    m = np.asarray(h.found)
    return (np.asarray(h.point)[m], np.asarray(h.normal)[m], d[m],
            np.asarray(h.index)[m])


def test_significance_and_fresnel():
    rng = np.random.default_rng(6)
    col = rng.uniform(0, 2e-3, (200, 3)).astype(np.float32)
    equal(tsh.is_significant(t(col)), jsh.is_significant(col))
    n1, n2 = (rng.uniform(0.9, 2.0, 300).astype(np.float32) for _ in range(2))
    c1, c2 = (rng.uniform(-1, 1, 300).astype(np.float32) for _ in range(2))
    c2[:20] = -c1[:20] * n1[:20] / n2[:20]   # denominator ~ 0: full reflection
    close(tsh.polarised_reflection(t(n1), t(n2), t(c1), t(c2)),
          jsh.polarised_reflection(n1, n2, c1, c2))


def test_matte_light_sum():
    js, ts = scenes()
    point, normal, _, _ = _hits(js, *rays())
    got = tsh.matte_light_sum(t(point), t(normal), ts.spheres, ts.lights)
    want = jsh.matte_light_sum(point, normal, js.spheres, js.lights)
    assert np.asarray(want).max() > 0
    close(got, want, atol=1e-10)


def test_reflect():
    js, _ = scenes()
    point, normal, d, _ = _hits(js, *rays())
    for g, w in zip(tsh.reflect(t(d), t(normal), t(point)),
                    jsh.reflect(d, normal, point)):
        close(g, w)


@pytest.mark.parametrize("medium_ior", [1.0, 1.6])
def test_refract(medium_ior):
    js, ts = scenes()
    point, normal, d, _ = _hits(js, *rays())
    mior = np.full(len(d), medium_ior, np.float32)
    got = tsh.refract(t(point), t(normal), t(d), t(mior), ts.spheres, ts.bg)
    want = jsh.refract(point, normal, d, jnp.asarray(mior), js.spheres, js.bg)
    close(got[0], want[0])
    close(got[1], want[1])
    close(got[2], want[2])
    equal(got[3], want[3])
