"""Benchmark scene builders shared by bench.py, parity_check.py and
chip_smoke.py.

``build_large_scene`` assembles the BASELINE config-4 regime: a ~1.1M
triangle mesh (a procedurally displaced sphere, made in-repo so no
external fixture is needed), a rough conductor material, and a constant
environment emitter.
"""
from __future__ import annotations

import numpy as np


def subdivide_midpoint(pos: np.ndarray, idx: np.ndarray, rounds: int = 1):
    """1:4 midpoint subdivision (no smoothing); vertices deduped per edge."""
    for _ in range(rounds):
        e = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]], idx[:, [2, 0]]])
        e_sorted = np.sort(e, axis=1)
        uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
        mid = 0.5 * (pos[uniq[:, 0]] + pos[uniq[:, 1]])
        m01 = len(pos) + inv[: len(idx)]
        m12 = len(pos) + inv[len(idx) : 2 * len(idx)]
        m20 = len(pos) + inv[2 * len(idx) :]
        i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
        idx = np.concatenate([
            np.stack([i0, m01, m20], 1),
            np.stack([m01, i1, m12], 1),
            np.stack([m20, m12, i2], 1),
            np.stack([m01, m12, m20], 1),
        ])
        pos = np.concatenate([pos, mid])
    return pos, idx


def _displaced_sphere(n_tris_target: int) -> tuple[np.ndarray, np.ndarray]:
    """UV sphere with radial noise, ~``n_tris_target`` triangles."""
    n = int(np.sqrt(n_tris_target / 2)) + 1
    th = np.linspace(1e-3, np.pi - 1e-3, n)
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.05 * np.sin(7 * T) * np.cos(9 * P)
    pos = np.stack([r * np.sin(T) * np.cos(P), r * np.cos(T),
                    r * np.sin(T) * np.sin(P)], -1).reshape(-1, 3) * 0.08
    idx = []
    for i in range(n - 1):
        for j in range(n):
            j2 = (j + 1) % n
            a, b, c, d = i * n + j, i * n + j2, (i + 1) * n + j, (i + 1) * n + j2
            idx += [[a, b, d], [d, c, a]]
    return pos, np.asarray(idx, np.int64)


def build_large_scene(width: int = 512, height: int | None = None,
                      subdiv: int = 2, max_depth: int = 3):
    """Scene with ~70k * 4**subdiv tris under a constant environment.

    Returns (scene, settings, n_tris).  ``subdiv`` 2 gives the ~1.1M
    triangle bench regime; 0 the 70k mesh, used by the parity check where a
    CPU-backend render must stay cheap."""
    from mitsuba_im_tpu.scene.build import SceneBuilder
    from mitsuba_im_tpu.scene.mesh import TriMesh
    from mitsuba_im_tpu.core.transform import Transform
    from mitsuba_im_tpu.core.registry import create as reg_create
    from mitsuba_im_tpu.core.properties import Properties
    from mitsuba_im_tpu.sensor.table import make_sensor, S_PERSPECTIVE
    from mitsuba_im_tpu.film.film import F_BOX

    height = height or width
    b = SceneBuilder()
    pos, idx = _displaced_sphere(70_000 * 4 ** subdiv)
    mesh = TriMesh(pos, idx).compute_normals()

    mat = Properties("roughconductor")
    mat.set("distribution", "ggx")
    mat.set("alpha", 0.2)
    bid = b.add_bsdf(reg_create("bsdf", mat, b))
    sid = b.new_shape(bid)
    b.add_trimesh(mesh, sid)
    b.add_emitter(reg_create("emitter", Properties("constant"), b))

    b.sensor = make_sensor(
        S_PERSPECTIVE,
        Transform.look_at([0.0, 0.05, 0.3], [0, 0, 0], [0, 1, 0]),
        fov_deg=40.0)
    b.settings.width = width
    b.settings.height = height
    b.settings.spp = 1
    b.settings.rfilter = F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=max_depth)
    scene, settings = b.build()
    return scene, settings, int(len(idx))
