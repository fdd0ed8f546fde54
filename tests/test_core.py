"""Core substrate tests: math, warps, RNG, distributions.

Mirrors the reference testcase plugins ``test_samplers.cpp`` /
``test_chisquare.cpp`` methodology (SURVEY.md §4): statistical validation of
sampling routines against their claimed pdfs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_im_tpu.core import math as m
from mitsuba_im_tpu.core import warp, rng as mrng
from mitsuba_im_tpu.core.distribution import Distribution1D, Distribution2D
from mitsuba_im_tpu.core.transform import Transform


def _uniform2(n, seed=1):
    s = mrng.make_sampler(jnp.arange(n), 0, seed)
    _, u = mrng.next_2d(s)
    return np.asarray(u)


class TestMath:
    def test_coordinate_system_orthonormal(self):
        n = m.normalize(jnp.asarray(_uniform2(128 * 3, 3).reshape(-1, 3) * 2 - 1))
        s, t = m.coordinate_system(n)
        np.testing.assert_allclose(np.asarray(m.dot(s, t)), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(m.dot(s, n)), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(m.norm(s)), 1, atol=1e-5)

    def test_frame_roundtrip(self):
        n = m.normalize(jnp.asarray([[0.3, -0.2, 0.9], [0.0, 0.0, -1.0]]))
        f = m.Frame.from_normal(n)
        v = m.normalize(jnp.asarray([[0.5, 0.5, 0.5], [-0.1, 0.9, 0.2]]))
        v2 = m.Frame.to_world(f, m.Frame.to_local(f, v))
        np.testing.assert_allclose(np.asarray(v2), np.asarray(v), atol=1e-5)

    def test_reflect(self):
        wi = m.normalize(jnp.asarray([[0.3, 0.4, 0.8]]))
        wo = m.reflect(wi)
        assert np.allclose(wo[0, 2], wi[0, 2])
        assert np.allclose(wo[0, :2], -wi[0, :2])

    def test_transform_compose(self):
        t = Transform.translate([1, 2, 3]) @ Transform.scale([2, 2, 2])
        p = t.apply_point([1, 0, 0])
        np.testing.assert_allclose(p, [3, 2, 3])
        back = t.inverse().apply_point(p)
        np.testing.assert_allclose(back, [1, 0, 0], atol=1e-12)

    def test_look_at(self):
        t = Transform.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0])
        d = t.apply_vector([0, 0, 1])
        np.testing.assert_allclose(d, [0, 0, 1], atol=1e-12)
        o = t.apply_point([0, 0, 0])
        np.testing.assert_allclose(o, [0, 0, -5])


class TestWarp:
    """Monte Carlo moment checks: E[f(X)] under the warp's pdf."""

    N = 1 << 16

    def test_cosine_hemisphere(self):
        d = np.asarray(warp.square_to_cosine_hemisphere(jnp.asarray(_uniform2(self.N))))
        assert np.all(d[:, 2] >= -1e-6)
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1, atol=1e-3)
        # E[cos theta] under cosine-weighted pdf = 2/3
        np.testing.assert_allclose(d[:, 2].mean(), 2.0 / 3.0, atol=0.01)

    def test_uniform_sphere(self):
        d = np.asarray(warp.square_to_uniform_sphere(jnp.asarray(_uniform2(self.N, 7))))
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1, atol=1e-3)
        np.testing.assert_allclose(d.mean(axis=0), [0, 0, 0], atol=0.02)

    def test_concentric_disk(self):
        p = np.asarray(
            warp.square_to_uniform_disk_concentric(jnp.asarray(_uniform2(self.N, 9)))
        )
        r2 = (p ** 2).sum(1)
        assert np.all(r2 <= 1 + 1e-5)
        # E[r^2] for uniform disk = 1/2
        np.testing.assert_allclose(r2.mean(), 0.5, atol=0.01)

    def test_uniform_triangle(self):
        b = np.asarray(warp.square_to_uniform_triangle(jnp.asarray(_uniform2(self.N, 11))))
        assert np.all(b >= -1e-6) and np.all(b.sum(1) <= 1 + 1e-5)
        # Centroid of unit triangle barycentrics = (1/3, 1/3)
        np.testing.assert_allclose(b.mean(axis=0), [1 / 3, 1 / 3], atol=0.01)

    def test_uniform_cone(self):
        cc = 0.8
        d = np.asarray(
            warp.square_to_uniform_cone(cc, jnp.asarray(_uniform2(self.N, 13)))
        )
        assert np.all(d[:, 2] >= cc - 1e-5)
        np.testing.assert_allclose(d[:, 2].mean(), (1 + cc) / 2, atol=0.01)


class TestRng:
    def test_determinism(self):
        s1 = mrng.make_sampler(jnp.arange(100), 3, 42)
        s2 = mrng.make_sampler(jnp.arange(100), 3, 42)
        _, a = mrng.next_1d(s1)
        _, b = mrng.next_1d(s2)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_decorrelation(self):
        s = mrng.make_sampler(jnp.arange(4096), 0, 1)
        s, a = mrng.next_1d(s)
        s, b = mrng.next_1d(s)
        a, b = np.asarray(a), np.asarray(b)
        assert abs(np.corrcoef(a, b)[0, 1]) < 0.05
        assert abs(a.mean() - 0.5) < 0.02
        assert abs(a.var() - 1 / 12) < 0.005

    def test_stratified_covers_strata(self):
        spp = 16
        s = mrng.make_sampler(
            jnp.zeros(spp, jnp.uint32), jnp.arange(spp), 0,
            kind=mrng.STRATIFIED, spp=spp,
        )
        _, u = mrng.next_2d(s)
        u = np.asarray(u)
        cells = set(
            (int(x * 4), int(y * 4)) for x, y in u
        )
        assert len(cells) == 16  # every 4x4 stratum hit exactly once

    def test_ld_sequence_low_discrepancy(self):
        n = 1024
        s = mrng.make_sampler(
            jnp.zeros(n, jnp.uint32), jnp.arange(n), 5, kind=mrng.LDSAMPLER
        )
        _, u = mrng.next_2d(s)
        u = np.asarray(u)
        # every one of the 32x32 elementary cells gets exactly one point
        cells = set((int(x * 32), int(y * 32)) for x, y in u)
        assert len(cells) == 1024


class TestDistribution:
    def test_1d_sampling_frequencies(self):
        w = jnp.asarray([1.0, 2.0, 3.0, 4.0])
        d = Distribution1D.from_weights(w)
        u = jnp.asarray(_uniform2(1 << 15, 17)[:, 0])
        idx, p = d.sample(u)
        counts = np.bincount(np.asarray(idx), minlength=4) / idx.shape[0]
        np.testing.assert_allclose(counts, np.asarray(w) / 10.0, atol=0.01)
        np.testing.assert_allclose(np.asarray(d.integral), 10.0)

    def test_2d_sampling_density(self):
        wmap = jnp.asarray([[1.0, 0.0], [1.0, 2.0]])
        d = Distribution2D.from_weights(wmap)
        uv, pdf = d.sample_continuous(jnp.asarray(_uniform2(1 << 15, 23)))
        uv = np.asarray(uv)
        # quadrant frequencies should match weights / 4
        q = (uv[:, 0] >= 0.5).astype(int) + 2 * (uv[:, 1] >= 0.5).astype(int)
        counts = np.bincount(q, minlength=4) / len(q)
        np.testing.assert_allclose(counts, [0.25, 0.0, 0.25, 0.5], atol=0.01)
        # pdf at sampled points integrates to 1: E[1/pdf * pdf]/N trivial;
        # check pdf values match analytic density (4 * weight/sum)
        expect = np.array([1.0, 0.0, 1.0, 2.0])
        np.testing.assert_allclose(
            np.asarray(pdf), expect[q], atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(d.pdf_continuous(jnp.asarray(uv))), expect[q], atol=1e-4
        )


class TestAliasSampling:
    """O(1) alias-table path of Distribution2D (device-side replacement for the
    envmap CDF binary search, /root/reference/src/emitters/envmap.cpp)."""

    def test_alias_cell_frequencies_match_pmf(self):
        rng = np.random.default_rng(5)
        w = (rng.uniform(0, 1, (8, 16)) ** 2).astype(np.float32)
        d = Distribution2D.from_weights(jnp.asarray(w))
        assert d.marg_aprob is not None  # alias path active
        n = 1 << 17
        uv, pdf = d.sample_continuous(jnp.asarray(_uniform2(n, 31)))
        uv = np.asarray(uv)
        col = np.clip((uv[:, 0] * 16).astype(int), 0, 15)
        row = np.clip((uv[:, 1] * 8).astype(int), 0, 7)
        hist = np.zeros((8, 16))
        np.add.at(hist, (row, col), 1.0)
        hist /= n
        np.testing.assert_allclose(hist, w / w.sum(), atol=4e-3)
        # reported pdf == analytic texel density at the sampled cell
        np.testing.assert_allclose(
            np.asarray(pdf), (w / w.sum() * 8 * 16)[row, col], rtol=1e-4)

    def test_alias_within_texel_uniform(self):
        """Sample-reuse offsets must stay uniform inside each texel."""
        w = np.ones((4, 4), np.float32)
        w[1, 2] = 7.0
        d = Distribution2D.from_weights(jnp.asarray(w))
        n = 1 << 16
        uv, _ = d.sample_continuous(jnp.asarray(_uniform2(n, 11)))
        uv = np.asarray(uv)
        sel = (uv[:, 0] >= 0.5) & (uv[:, 0] < 0.75) & \
              (uv[:, 1] >= 0.25) & (uv[:, 1] < 0.5)
        fx = (uv[sel, 0] - 0.5) / 0.25
        fy = (uv[sel, 1] - 0.25) / 0.25
        # 4-bin chi-square-ish uniformity per axis
        for f in (fx, fy):
            c = np.bincount(np.clip((f * 4).astype(int), 0, 3), minlength=4)
            np.testing.assert_allclose(c / c.sum(), 0.25, atol=0.03)

    @pytest.mark.slow
    def test_alias_matches_cdf_pdf(self):
        """Alias and CDF paths agree on the density they report."""
        rng = np.random.default_rng(9)
        w = (rng.uniform(0, 1, (6, 10)) + 0.01).astype(np.float32)
        d = Distribution2D.from_weights(jnp.asarray(w))
        d_cdf = Distribution2D(cond_cdf=d.cond_cdf, cond_pmf=d.cond_pmf,
                               marg_cdf=d.marg_cdf, marg_pmf=d.marg_pmf)
        s = jnp.asarray(_uniform2(4096, 3))
        uv_a, pdf_a = d.sample_continuous(s)
        uv_c, pdf_c = d_cdf.sample_continuous(s)
        np.testing.assert_allclose(
            np.asarray(d.pdf_continuous(uv_a)), np.asarray(pdf_a), rtol=1e-4)
        np.testing.assert_allclose(
            np.asarray(d.pdf_continuous(uv_c)), np.asarray(pdf_c), rtol=1e-4)


class TestProperties:
    def test_query_recording(self):
        from mitsuba_im_tpu.core.properties import Properties

        p = Properties("diffuse").record_queries_and_defaults(True)
        assert p.get_float("alpha", 0.2) == 0.2
        p.set("beta", 3)
        assert p.get_int("beta", 7) == 3
        assert p.recorded_defaults == {"alpha": 0.2}
        assert p.unqueried() == []

    def test_merge_diff(self):
        from mitsuba_im_tpu.core.properties import Properties

        a = Properties("x", {"p": 1.0, "q": 2.0})
        b = Properties("x", {"q": 5.0})
        merged = a.merge(b)
        assert merged.get_float("q") == 5.0 and merged.get_float("p") == 1.0
        assert a.diff({"p": 1.0, "q": 2.0}) == {}
        assert b.diff({"q": 2.0}) == {"q": 5.0}
