"""End-to-end render tests: the minimum slice of SURVEY.md §7 stage 3.

- white furnace: constant environment + albedo-1 sphere must integrate to
  exactly the env radiance (validates NEE+MIS+RR unbiasedness end to end);
- Cornell box from mitsuba-format XML (validates the loader + full path);
- path(maxDepth=2) vs direct integrator agreement (same estimator class);
- BVH vs brute-force render equality.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from mitsuba_im_tpu.scene.xml import load_scene
from mitsuba_im_tpu.scene.build import SceneBuilder
from mitsuba_im_tpu.scene.cornell import write_cornell
from mitsuba_im_tpu.scene.mesh import TriMesh
from mitsuba_im_tpu.render.job import render, render_film
from mitsuba_im_tpu.film.film import develop, F_BOX
from mitsuba_im_tpu.core.transform import Transform
from mitsuba_im_tpu.sensor.table import make_sensor, S_PERSPECTIVE
from mitsuba_im_tpu.emitter import table as et
from mitsuba_im_tpu.bsdf import common as bc




def write_scene(tmp_path, **kw):
    return write_cornell(os.path.join(tmp_path, "cornell.xml"), **kw)


@pytest.fixture(scope="module")
def tmpdir_mod(tmp_path_factory):
    return str(tmp_path_factory.mktemp("scenes"))


class TestFurnace:
    def test_white_furnace(self):
        """Albedo-1 sphere in a unit constant environment -> exactly 1."""
        b = SceneBuilder()
        rec = bc.default_record()
        rec["type"] = bc.DIFFUSE
        rec["refl"] = np.ones(3)
        bid = b.add_bsdf(rec)
        sid = b.new_shape(bid)
        b.add_sphere([0, 0, 0], 1.0, sid)
        b.add_emitter(dict(type=et.EM_CONSTANT, radiance=np.ones(3)))
        b.sensor = make_sensor(
            S_PERSPECTIVE, Transform.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]),
            fov_deg=40.0,
        )
        b.settings.width = b.settings.height = 24
        b.settings.spp = 24
        b.settings.rfilter = F_BOX
        b.settings.integrator = "path"
        b.settings.integrator_props = dict(max_depth=-1, rr_depth=8)
        scene, settings = b.build()
        img = render(scene, settings)
        assert np.isfinite(img).all()
        # every pixel (sphere or background) must equal 1 in expectation
        np.testing.assert_allclose(img.mean(), 1.0, atol=0.015)
        assert abs(img.mean(axis=(0, 1)) - 1.0).max() < 0.02


class TestCornell:
    def test_load_and_render(self, tmpdir_mod):
        path = write_scene(tmpdir_mod, max_depth=3, spp=8, res=24)
        scene, settings = load_scene(path)
        assert settings.width == 24 and settings.spp == 8
        assert settings.integrator == "path"
        img = render(scene, settings)
        assert img.shape == (24, 24, 3)
        assert np.isfinite(img).all() and (img >= 0).all()
        assert img.mean() > 0.01  # light reaches the film
        # left half reddish, right half greenish (wall colors)
        left = img[:, :6].mean(axis=(0, 1))
        right = img[:, -6:].mean(axis=(0, 1))
        assert left[0] > left[2]
        assert right[1] > right[0]

    def test_path_depth2_equals_direct(self, tmpdir_mod):
        """With the stateless sampler both integrators consume the identical
        RNG stream at maxDepth=2, so their estimates match exactly — the
        strongest cross-integrator consistency check."""
        path = write_scene(tmpdir_mod, max_depth=2, spp=12, res=16)
        scene, settings = load_scene(path)
        img_path = render(scene, settings)
        settings.integrator = "direct"
        settings.integrator_props = dict(emitter_samples=1, bsdf_samples=1)
        img_direct = render(scene, settings)
        np.testing.assert_allclose(img_path, img_direct, atol=2e-4, rtol=1e-3)

    def test_ao_and_field(self, tmpdir_mod):
        path = write_scene(tmpdir_mod, max_depth=2, spp=4, res=16)
        scene, settings = load_scene(path)
        settings.integrator = "ao"
        settings.integrator_props = dict(shading_samples=1, ray_length=-1.0)
        img = render(scene, settings)
        assert (img >= 0).all() and (img <= 1.0 + 1e-5).all()
        settings.integrator = "field"
        settings.integrator_props = dict(field="normal")
        imgn = render(scene, settings)
        assert np.isfinite(imgn).all()
        lens = np.linalg.norm(imgn, axis=-1)
        assert (lens[lens > 0.1] < 1.01).all()

    def test_bvh_matches_brute(self, tmpdir_mod):
        path = write_scene(tmpdir_mod, max_depth=2, spp=4, res=16)
        scene, settings = load_scene(path)
        img_brute = render(scene, settings)
        from mitsuba_im_tpu.accel import bvh as bvh_mod

        lo, hi = bvh_mod.tri_bounds(
            np.asarray(scene.geom.tri_p0), np.asarray(scene.geom.tri_e1),
            np.asarray(scene.geom.tri_e2),
        )
        scene_bvh = scene.replace(bvh=bvh_mod.build_bvh(lo, hi), use_bvh=True)
        img_bvh = render(scene_bvh, settings)
        np.testing.assert_allclose(img_bvh, img_brute, atol=1e-5)
