"""Cluster-rendering tests: the local-subprocess stand-in for a network
node that SURVEY.md §4 calls for (``mtssrv -ls`` over a pipe)."""
import os
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mitsuba_im_tpu.parallel import remote


@pytest.fixture(scope="module")
def cornell():
    from __graft_entry__ import _tiny_cornell

    scene, settings = _tiny_cornell()
    settings.width = settings.height = 16
    settings.spp = 8
    return scene, settings


class TestProtocol:
    def test_framing_roundtrip(self, tmp_path):
        p = tmp_path / "stream.bin"
        with open(p, "wb") as w:
            remote.send_msg(w, {"type": "x", "n": 3}, [b"abc", b""])
            remote.send_msg(w, {"type": "y"})
        with open(p, "rb") as r:
            h1, b1 = remote.recv_msg(r)
            h2, b2 = remote.recv_msg(r)
        assert h1 == {"type": "x", "n": 3} and b1 == [b"abc", b""]
        assert h2 == {"type": "y"} and b2 == []

    def test_resource_roundtrip(self, cornell):
        scene, settings = cornell
        payload = remote.dumps_resource(scene, settings)
        rid = remote.resource_id(payload)
        assert len(rid) == 24
        scene2, settings2 = remote.loads_resource(payload)
        assert settings2.width == settings.width
        assert scene2.geom.n_tris == scene.geom.n_tris

    def test_unpickler_blocks_arbitrary_classes(self):
        import pickle

        evil = pickle.dumps(os.system)
        with pytest.raises(pickle.UnpicklingError):
            remote._RestrictedUnpickler(__import__("io").BytesIO(evil)).load()


class TestInProcessBackend:
    """StreamBackend over an in-process socketpair (no subprocess cost)."""

    def test_work_unit_roundtrip(self, cornell):
        import socket

        scene, settings = cornell
        a, b = socket.socketpair()
        backend = remote.StreamBackend(b.makefile("rb"), b.makefile("wb"))
        t = threading.Thread(target=backend.run, daemon=True)
        t.start()

        rfile, wfile = a.makefile("rb"), a.makefile("wb")
        hello, _ = remote.recv_msg(rfile)
        assert hello["type"] == "hello"

        payload = remote.dumps_resource(scene, settings)
        rid = remote.resource_id(payload)
        remote.send_msg(wfile, {"type": "has_resource", "id": rid})
        st, _ = remote.recv_msg(rfile)
        assert st["cached"] is False
        remote.send_msg(wfile, {"type": "new_resource", "id": rid}, [payload])
        ack, _ = remote.recv_msg(rfile)
        assert ack["type"] == "resource_ack"

        remote.send_msg(wfile, {"type": "work_unit", "unit_id": 7,
                                "resource_id": rid, "sample_offset": 0,
                                "count": 2})
        res, blobs = remote.recv_msg(rfile)
        assert res["type"] == "work_result" and res["unit_id"] == 7
        data = np.frombuffer(blobs[0], np.float32).reshape(res["shape"])
        assert data.shape == (16, 16, 4)
        assert np.isfinite(data).all() and data[..., 3].sum() > 0

        # unknown resource -> work_failed, connection stays usable
        remote.send_msg(wfile, {"type": "work_unit", "unit_id": 8,
                                "resource_id": "nope", "sample_offset": 0,
                                "count": 1})
        res2, _ = remote.recv_msg(rfile)
        assert res2["type"] == "work_failed"
        remote.send_msg(wfile, {"type": "quit"})
        t.join(timeout=10)


class TestDistributedRender:
    def test_matches_single_process(self, cornell):
        """Full client path against one `mtssrv -ls` subprocess node.

        The stateless sampler makes the distributed result bitwise equal to
        the single-process render regardless of the unit partitioning."""
        scene, settings = cornell
        from mitsuba_im_tpu.render.job import render

        ref = render(scene, settings)
        # force the node onto the CPU platform to match the test process
        node_argv = [
            sys.executable, "-c",
            "import jax; jax.config.update('jax_platforms','cpu'); "
            "from mitsuba_im_tpu.cli.mtssrv import main; main(['-ls','-q'])",
        ]
        img = remote.render_distributed(
            scene, settings, [node_argv], include_local=True, unit_spp=2)
        np.testing.assert_allclose(img, ref, atol=1e-5)

    def test_node_failure_falls_back_to_local(self, cornell):
        scene, settings = cornell
        from mitsuba_im_tpu.render.job import render

        ref = render(scene, settings)
        # a node that dies immediately: its units are re-queued locally
        img = remote.render_distributed(
            scene, settings, ["exec:false"], include_local=True, unit_spp=4)
        np.testing.assert_allclose(img, ref, atol=1e-5)
