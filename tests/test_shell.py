"""Terminal shell tests (im-mts shell.cpp analog) — headless: key
handling, camera state round-trip, ANSI presenter, hot reload."""
import os
import time

import numpy as np

from mitsuba_im_tpu.interactive.shell import (
    FlyCamera, TerminalShell, frame_to_ansi,
)


def test_fly_camera_roundtrip():
    from mitsuba_im_tpu.core.transform import Transform

    t = Transform.look_at([1.0, 2.0, 3.0], [0.0, 1.0, 0.5], [0, 1, 0])
    cam = FlyCamera(t.m)
    np.testing.assert_allclose(cam.pos, [1, 2, 3], atol=1e-6)
    # rebuilt transform must reproduce the original forward axis
    t2 = cam.to_world()
    np.testing.assert_allclose(np.asarray(t2.m)[:3, 2],
                               np.asarray(t.m)[:3, 2], atol=1e-6)
    # motion moves along view axes
    p0 = cam.pos.copy()
    cam.move(dz=1.0, speed=0.5)
    np.testing.assert_allclose(
        cam.pos, p0 + 0.5 * cam.forward(), atol=1e-9)


def test_frame_to_ansi_shape():
    img = np.zeros((64, 64, 3), np.float32)
    img[:32] = [1.0, 0.0, 0.0]
    s = frame_to_ansi(img, cols=40, rows=11, exposure=1.0, status="hi")
    lines = s.split("\n")
    assert len(lines) == 11  # 10 pixel-pair rows + status
    assert "▀" in s and "38;2;255;0;0" in s
    assert s.rstrip().endswith("hi")


CORNELL = None


def _scene():
    global CORNELL
    if CORNELL is None:
        from mitsuba_im_tpu.scene.cornell import cornell_xml

        xml = cornell_xml(res=32, spp=1, max_depth=3)
        import tempfile

        d = tempfile.mkdtemp()
        p = os.path.join(d, "s.xml")
        with open(p, "w") as f:
            f.write(xml)
        from mitsuba_im_tpu.scene.xml import load_scene

        CORNELL = (p, *load_scene(p))
    return CORNELL


def test_shell_keys_and_frames():
    path, scene, settings = _scene()
    sh = TerminalShell(scene, settings, scene_path=path, preview_scale=2)
    sh.actor.start()
    try:
        deadline = time.time() + 60
        while sh.actor.latest() is None and time.time() < deadline:
            time.sleep(0.05)
        assert sh.actor.latest() is not None
        frame = sh.render_frame(60, 18)
        assert "▀" in frame and "spp" in frame

        # camera move restarts accumulation with a new generation
        gen0 = sh.actor.latest().generation
        sh.handle_key("w")
        assert sh._dirty_cam
        sh.flush_camera()
        deadline = time.time() + 60
        while time.time() < deadline:
            rev = sh.actor.latest()
            if rev is not None and rev.generation > gen0:
                break
            time.sleep(0.05)
        assert sh.actor.latest().generation > gen0

        # exposure & pause & quit verbs
        e0 = sh.exposure
        sh.handle_key("]")
        assert sh.exposure > e0
        sh.handle_key("p")
        assert sh.actor.controls.paused
        sh.handle_key("p")
        sh.handle_key("q")
        assert sh.quit
    finally:
        sh.actor.stop()


def test_hot_reload(tmp_path):
    path, scene, settings = _scene()
    import shutil

    p2 = os.path.join(str(tmp_path), "live.xml")
    shutil.copy(path, p2)
    sh = TerminalShell(scene, settings, scene_path=p2, preview_scale=2)
    old_scene = sh.scene
    # touch with modified content
    time.sleep(0.01)
    with open(p2) as f:
        text = f.read()
    with open(p2, "w") as f:
        f.write(text.replace('value="0.63 0.065 0.05"',
                             'value="0.1 0.1 0.8"'))
    os.utime(p2, (time.time() + 5, time.time() + 5))
    sh.check_reload()
    assert sh.scene is not old_scene
