"""Responsive progressive rendering — the fork's signature capability.

Rebuild of the im-mts interactive stack
(``/root/reference/src/im-mts/scene.cpp:265-473`` InteractiveSceneProcess,
``src/librender/integrator.cpp:336-405`` ImageOrderIntegrator,
``include/mitsuba/render/integrator2.h:49`` ResponsiveIntegrator) in
Wavefront form:

- the unit of cooperative scheduling is one jitted 1-spp pass (hundreds of
  microseconds to tens of ms on chip) instead of a 64-sample pixel strip —
  the host checks controls between device launches (the analog of the
  ``Controls{continu, abort, interrupt}`` flags polled every 64 samples);
- camera motion restarts accumulation with a fresh film and a *reduced
  resolution* first pass (the analog of StackedPreview's mip fallback,
  ``preview_opengl2.cpp:299-307``), then refines at full resolution;
- film revisions are published with a monotonically increasing generation
  counter (the analog of the preview generation/timestamp protocol,
  ``shell.h:113-129``);
- on sample exhaustion the pass sequence simply continues with new sample
  indices (the counter-based sampler never exhausts — the analog of the
  fork's 2x-samples + rescramble restart, scene.cpp:437-461).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import jax

from ..film.film import make_film, develop, F_BOX
from ..render.job import _render_pass, _integrator_fn
from ..core import rng as mrng
from ..sampler import KIND_BY_NAME
from ..scene.build import RenderSettings
from ..scene.scene import Scene


@dataclass
class Controls:
    """Cooperative control block (integrator2.h:52-61 analog)."""

    continu: bool = True
    abort: bool = False
    paused: bool = False


@dataclass
class FilmRevision:
    image: np.ndarray
    spp: int
    generation: int
    resolution_scale: int  # 1 = full res; >1 = preview mip


class RenderActor:
    """Background progressive renderer with live scene/camera updates."""

    def __init__(self, scene: Scene, settings: RenderSettings,
                 preview_scale: int = 4, max_spp: int | None = None):
        self.settings = settings
        self.preview_scale = preview_scale
        self.max_spp = max_spp
        self.controls = Controls()
        self._scene = scene
        self._pending_scene: Scene | None = None
        self._pending_settings: RenderSettings | None = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._revision: FilmRevision | None = None
        self._generation = 0
        self._thread: threading.Thread | None = None
        self.spp_done = 0
        self.pass_times: list[float] = []

    # -- control surface (UI thread) ----------------------------------------
    def update_scene(self, scene: Scene):
        """Queue a scene/camera change; takes effect at the next pass
        boundary (the WorkLane::synchronized analog, scene.cpp:544-563)."""
        with self._lock:
            self._pending_scene = scene

    def update_settings(self, settings: RenderSettings):
        """Queue a settings swap (integrator/sampler/film reconfiguration —
        the configurator Changes::apply analog, configurator.cpp:303-362).
        Accumulation restarts at the next pass boundary."""
        with self._lock:
            self._pending_settings = settings

    def pause(self, value: bool = True):
        with self._cv:
            self.controls.paused = value
            self._cv.notify_all()

    def stop(self):
        with self._cv:
            self.controls.abort = True
            self.controls.paused = False
            self._cv.notify_all()
        if self._thread:
            self._thread.join(timeout=30)

    def latest(self) -> FilmRevision | None:
        with self._lock:
            return self._revision

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    # -- render loop ---------------------------------------------------------
    def _publish(self, film, spp, scale):
        img = np.asarray(develop(film))
        with self._lock:
            self._generation += 1
            self._revision = FilmRevision(img, spp, self._generation, scale)

    def _settings_at(self, scale: int) -> RenderSettings:
        import copy

        s = copy.copy(self.settings)
        s.width = max(self.settings.width // scale, 8)
        s.height = max(self.settings.height // scale, 8)
        return s

    def _run(self):
        scene = self._scene
        restart = True
        while not self.controls.abort:
            with self._cv:
                while self.controls.paused and not self.controls.abort:
                    self._cv.wait()  # condvar pause (scene.cpp:385-397 analog)
                if self._pending_scene is not None:
                    scene = self._pending_scene
                    self._pending_scene = None
                    restart = True
                if self._pending_settings is not None:
                    self.settings = self._pending_settings
                    self._pending_settings = None
                    restart = True
            if self.controls.abort:
                break

            if restart:
                # preview pass at reduced resolution first
                s_prev = self._settings_at(self.preview_scale)
                film_prev = self._one_pass_film(scene, s_prev, 0)
                self._publish(film_prev, 1, self.preview_scale)
                film = make_film(self.settings.width, self.settings.height,
                                 self.settings.rfilter,
                                 self.settings.rfilter_radius)
                self.spp_done = 0
                restart = False
                continue

            t0 = time.perf_counter()
            film = self._accumulate_pass(scene, film, self.spp_done)
            film.data.block_until_ready()
            self.pass_times.append(time.perf_counter() - t0)
            self.spp_done += 1
            self._publish(film, self.spp_done, 1)
            if self.max_spp is not None and self.spp_done >= self.max_spp:
                break

    def _li_fn(self):
        return _integrator_fn(self.settings)

    def _accumulate_pass(self, scene, film, sample_idx):
        s = self.settings
        kind = KIND_BY_NAME.get(s.sampler, mrng.INDEPENDENT)
        data = _render_pass(
            scene, film.data, np.uint32(sample_idx), np.uint32(s.seed),
            width=film.width, height=film.height, spp=max(s.spp, 1), kind=kind,
            li_fn=self._li_fn(), ftype=film.ftype, radius=film.radius,
        )
        return film.replace(data=data)

    def _one_pass_film(self, scene, s: RenderSettings, sample_idx):
        film = make_film(s.width, s.height, F_BOX, 0.5)
        kind = KIND_BY_NAME.get(s.sampler, mrng.INDEPENDENT)
        data = _render_pass(
            scene, film.data, np.uint32(sample_idx), np.uint32(s.seed),
            width=s.width, height=s.height, spp=1, kind=kind,
            li_fn=self._li_fn(), ftype=film.ftype, radius=film.radius,
        )
        return film.replace(data=data)
