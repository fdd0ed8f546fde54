"""Cluster rendering over byte streams — the device-side analog of the
reference's remote scheduler + ``mtssrv`` network node.

Reference surface reproduced here (see SURVEY.md §2.1/§2.6/§3.4):

- ``RemoteWorker``/``StreamBackend`` message protocol
  (``/root/reference/include/mitsuba/core/sched_remote.h:221-237`` EMessage):
  here a small framed protocol (JSON header + binary blobs) with message
  types hello / new_resource / work_unit / work_result / cancel / quit.
- per-node **resource caching** (send the scene once, reference it by id in
  every work unit — ``sched_remote.cpp`` ENewResource path): resources are
  content-hashed and cached on the node across work units *and* connections.
- **work-unit pipelining** with a bounded backlog per node
  (``sched_remote.h:29-36`` keeps 3x cores in flight, refills at 2x): each
  node connection keeps ``BACKLOG`` sample-range units in flight.
- ``mtssrv -ls`` stdin/stdout mode for SSH tunnelling
  (``/root/reference/src/mitsuba/mtssrv.cpp:203``): node spec
  ``exec:ssh user@host python -m mitsuba_im_tpu.cli.mtssrv -ls`` spawns the
  worker over a pipe; plain ``host[:port]`` uses TCP (default port 7554).

Design decisions (vs. the reference's tile WorkUnits):

- The unit of distribution is a **sample-index range**, not an image tile:
  every node renders the full image for its sample indices and returns the
  accumulated film (data channels include the filter weight), so merging is
  a single sum — the stateless counter-based sampler guarantees the result
  is bitwise independent of how samples were partitioned across nodes.
- The scene crosses the wire as the *built* scene pytree (arrays as raw
  little-endian buffers), not XML — the analog of the reference serializing
  the instantiated scene object rather than its description.

Trust model matches the reference: the protocol authenticates nothing and
is meant for trusted render farms only (deserialization is restricted to
this package's dataclasses + numpy arrays; no arbitrary classes).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import queue
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np

DEFAULT_PORT = 7554  # sched_remote.h:27
PROTOCOL_VERSION = 1
BACKLOG = 3  # in-flight work units per node (sched_remote.h:29-36)

# ---------------------------------------------------------------------------
# framing: <u32 header_len> <header json> <u32 n_blobs> (<u64 len> bytes)*
# ---------------------------------------------------------------------------


def send_msg(wfile, header: dict, blobs: list[bytes] = ()) -> None:
    h = json.dumps(header).encode()
    wfile.write(struct.pack("<I", len(h)))
    wfile.write(h)
    wfile.write(struct.pack("<I", len(blobs)))
    for b in blobs:
        wfile.write(struct.pack("<Q", len(b)))
        wfile.write(b)
    wfile.flush()


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("stream closed mid-message")
        buf += chunk
    return buf


def recv_msg(rfile):
    (hlen,) = struct.unpack("<I", _read_exact(rfile, 4))
    header = json.loads(_read_exact(rfile, hlen))
    (nblobs,) = struct.unpack("<I", _read_exact(rfile, 4))
    blobs = []
    for _ in range(nblobs):
        (blen,) = struct.unpack("<Q", _read_exact(rfile, 8))
        blobs.append(_read_exact(rfile, blen))
    return header, blobs


# ---------------------------------------------------------------------------
# restricted scene serialization: pytree of arrays -> (structure, buffers)
# ---------------------------------------------------------------------------


class _RestrictedUnpickler(pickle.Unpickler):
    """Allow only this package's dataclasses, numpy scalars, and builtins —
    the analog of the reference's registered-Class-only unserialization
    (``include/mitsuba/core/class.h:99``)."""

    _SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "complex"}

    def find_class(self, module, name):
        if module.startswith("mitsuba_im_tpu"):
            return super().find_class(module, name)
        if module in ("numpy", "numpy._core.multiarray", "numpy.core.multiarray",
                      "numpy._core.numeric", "numpy.core.numeric", "numpy.dtypes"):
            return super().find_class(module, name)
        if module == "builtins" and name in self._SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"blocked class {module}.{name}")


def _to_numpy_tree(obj):
    import jax

    def conv(x):
        if hasattr(x, "__array__") and not isinstance(x, (str, bytes)):
            return np.asarray(x)
        return x

    return jax.tree_util.tree_map(conv, obj)


def dumps_resource(scene, settings) -> bytes:
    payload = {"scene": _to_numpy_tree(scene), "settings": _to_numpy_tree(settings)}
    return pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)


def loads_resource(data: bytes):
    payload = _RestrictedUnpickler(io.BytesIO(data)).load()
    return payload["scene"], payload["settings"]


def resource_id(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:24]


# ---------------------------------------------------------------------------
# server side — the mtssrv analog (StreamBackend, sched_remote.cpp:333)
# ---------------------------------------------------------------------------


class StreamBackend:
    """Serves the worker protocol over one (rfile, wfile) byte-stream pair."""

    def __init__(self, rfile, wfile, log=lambda *_: None,
                 resource_cache: dict | None = None):
        self.rfile, self.wfile = rfile, wfile
        self.log = log
        # shared across connections: reference nodes cache resources by id
        self.resources = resource_cache if resource_cache is not None else {}
        self._scenes = {}

    def run(self) -> None:
        import jax

        send_msg(self.wfile, {
            "type": "hello", "version": PROTOCOL_VERSION,
            "devices": jax.device_count(), "platform": jax.default_backend(),
        })
        while True:
            try:
                header, blobs = recv_msg(self.rfile)
            except (ConnectionError, EOFError):
                return
            t = header.get("type")
            if t == "quit":
                return
            elif t == "new_resource":
                rid = header["id"]
                self.resources[rid] = blobs[0]
                send_msg(self.wfile, {"type": "resource_ack", "id": rid})
                self.log(f"resource {rid} cached ({len(blobs[0])} bytes)")
            elif t == "has_resource":
                send_msg(self.wfile, {"type": "resource_status",
                                      "id": header["id"],
                                      "cached": header["id"] in self.resources})
            elif t == "work_unit":
                self._process(header)
            elif t == "ping":
                send_msg(self.wfile, {"type": "pong"})
            else:
                # protocol garbage: drop the connection (sched_remote.cpp:344)
                self.log(f"unknown message type {t!r}, closing")
                return

    def _scene_for(self, rid: str):
        if rid not in self._scenes:
            if rid not in self.resources:
                raise KeyError(f"resource {rid} not registered")
            self._scenes[rid] = loads_resource(self.resources[rid])
        return self._scenes[rid]

    def _process(self, header: dict) -> None:
        from ..render.job import render_film
        from ..scene.build import RenderSettings

        uid = header["unit_id"]
        try:
            scene, settings = self._scene_for(header["resource_id"])
            overrides = header.get("overrides") or {}
            if overrides:
                settings = RenderSettings(**{**settings.__dict__, **overrides})
            t0 = time.time()
            film = render_film(scene, settings, spp=header["count"],
                               sample_offset=header["sample_offset"])
            data = np.asarray(film.data, np.float32)
            send_msg(self.wfile, {
                "type": "work_result", "unit_id": uid,
                "count": header["count"], "shape": list(data.shape),
                "wall_s": time.time() - t0,
            }, [data.tobytes()])
            self.log(f"unit {uid}: {header['count']} spp in {time.time()-t0:.2f}s")
        except Exception as e:  # ECancelledWorkResult analog: report, keep serving
            send_msg(self.wfile, {"type": "work_failed", "unit_id": uid,
                                  "error": f"{type(e).__name__}: {e}"})
            self.log(f"unit {uid} FAILED: {e}")


def serve_stdio(log=lambda *_: None) -> None:
    """``mtssrv -ls``: speak the protocol over stdin/stdout (mtssrv.cpp:203)."""
    rfile = sys.stdin.buffer
    wfile = sys.stdout.buffer
    # anything the render path prints must not corrupt the protocol stream
    sys.stdout = sys.stderr
    StreamBackend(rfile, wfile, log=log).run()


def serve_tcp(port: int = DEFAULT_PORT, host: str = "", log=lambda *_: None,
              ready_event: threading.Event | None = None,
              stop_event: threading.Event | None = None) -> None:
    """``mtssrv``: accept loop, one StreamBackend thread per connection."""
    cache: dict = {}
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(8)
    srv.settimeout(0.25)
    log(f"listening on port {port}")
    if ready_event is not None:
        ready_event.set()
    try:
        while stop_event is None or not stop_event.is_set():
            try:
                conn, addr = srv.accept()
            except socket.timeout:
                continue
            log(f"connection from {addr}")
            rfile = conn.makefile("rb")
            wfile = conn.makefile("wb")
            t = threading.Thread(
                target=StreamBackend(rfile, wfile, log=log,
                                     resource_cache=cache).run,
                daemon=True)
            t.start()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# client side — RemoteWorker pool (sched_remote.h:50, RemoteWorkerReader :267)
# ---------------------------------------------------------------------------


class RemoteNode:
    """One connection to a render node; owns writer state + a reader loop."""

    def __init__(self, spec):
        self.spec = spec if isinstance(spec, str) else " ".join(spec)
        self.proc = None
        if not isinstance(spec, str) or spec.startswith("exec:"):
            # pipe transport — covers `exec:ssh user@host ... mtssrv -ls`
            # (the SSHStream analog, /root/reference/include/mitsuba/core/sshstream.h:47);
            # a list spec is used verbatim as the argv
            argv = list(spec) if not isinstance(spec, str) else spec[5:].split()
            self.proc = subprocess.Popen(
                argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            self.rfile, self.wfile = self.proc.stdout, self.proc.stdin
        else:
            host, _, port = spec.partition(":")
            sock = socket.create_connection((host, int(port or DEFAULT_PORT)),
                                            timeout=30)
            self.rfile = sock.makefile("rb")
            self.wfile = sock.makefile("wb")
        hello, _ = recv_msg(self.rfile)
        if hello.get("type") != "hello" or hello.get("version") != PROTOCOL_VERSION:
            raise ConnectionError(f"{spec}: bad hello {hello}")
        self.devices = hello.get("devices", 1)

    def ensure_resource(self, rid: str, payload: bytes) -> None:
        send_msg(self.wfile, {"type": "has_resource", "id": rid})
        status, _ = recv_msg(self.rfile)
        if not status.get("cached"):
            send_msg(self.wfile, {"type": "new_resource", "id": rid}, [payload])
            ack, _ = recv_msg(self.rfile)
            if ack.get("type") != "resource_ack":
                raise ConnectionError(f"{self.spec}: resource upload failed: {ack}")

    def send_unit(self, unit: dict) -> None:
        send_msg(self.wfile, {"type": "work_unit", **unit})

    def recv_result(self):
        header, blobs = recv_msg(self.rfile)
        if header.get("type") == "work_failed":
            raise RuntimeError(f"{self.spec}: {header.get('error')}")
        data = np.frombuffer(blobs[0], np.float32).reshape(header["shape"])
        return header, data

    def close(self) -> None:
        try:
            send_msg(self.wfile, {"type": "quit"})
        except Exception:
            pass
        for f in (self.rfile, self.wfile):
            try:
                f.close()
            except Exception:
                pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def render_distributed(scene, settings, nodes: list[str], spp: int | None = None,
                       unit_spp: int | None = None, include_local: bool = True,
                       log=lambda *_: None) -> np.ndarray:
    """Render ``spp`` samples split across remote nodes (+ this process).

    Mirrors the client side of SURVEY.md §3.4: register the scene resource
    once per node, keep BACKLOG units in flight per node, merge film
    accumulations as they stream back. Failure semantics follow the
    reference (sched_remote.cpp:293-308): a failed node's pending units are
    re-queued for the survivors; the job only fails if every worker dies.
    """
    from ..film.film import Film, make_film, develop
    from ..render.job import render_film

    spp = spp if spp is not None else settings.spp
    payload = dumps_resource(scene, settings)
    rid = resource_id(payload)

    n_workers = len(nodes) + (1 if include_local else 0)
    if unit_spp is None:
        unit_spp = max(1, spp // (BACKLOG * max(n_workers, 1) * 2))
    units = []
    off = 0
    while off < spp:
        cnt = min(unit_spp, spp - off)
        units.append({"unit_id": len(units), "resource_id": rid,
                      "sample_offset": off, "count": cnt})
        off += cnt

    work_q: queue.Queue = queue.Queue()
    for u in units:
        work_q.put(u)
    results: queue.Queue = queue.Queue()
    done_flag = threading.Event()  # set by the merger once all spp landed
    n_done = 0
    accum = None
    errors: list[str] = []

    def node_loop(spec: str) -> None:
        inflight: list[dict] = []
        node = None
        try:
            node = RemoteNode(spec)
            node.ensure_resource(rid, payload)
            while not done_flag.is_set():
                while len(inflight) < BACKLOG:
                    try:
                        u = work_q.get_nowait()
                    except queue.Empty:
                        break
                    node.send_unit(u)
                    inflight.append(u)
                if not inflight:
                    # stay connected until the job finishes — re-queued units
                    # from a failed peer may still arrive
                    done_flag.wait(timeout=0.2)
                    continue
                header, data = node.recv_result()
                done = next(u for u in inflight if u["unit_id"] == header["unit_id"])
                inflight.remove(done)
                results.put(("ok", data, done["count"]))
        except Exception as e:
            for u in inflight:  # resubmission upgrade over the reference
                work_q.put(u)
            results.put(("err", f"{spec}: {type(e).__name__}: {e}", 0))
        finally:
            if node is not None:
                node.close()

    threads = [threading.Thread(target=node_loop, args=(s,), daemon=True)
               for s in nodes]
    for t in threads:
        t.start()

    def local_loop() -> None:
        while not done_flag.is_set():
            try:
                u = work_q.get(timeout=0.2)
            except queue.Empty:
                continue
            film = render_film(scene, settings, spp=u["count"],
                               sample_offset=u["sample_offset"])
            results.put(("ok", np.asarray(film.data, np.float32), u["count"]))

    if include_local:
        lt = threading.Thread(target=local_loop, daemon=True)
        lt.start()
        threads.append(lt)

    live_workers = n_workers
    try:
        while n_done < spp:
            kind, data, cnt = results.get()
            if kind == "err":
                errors.append(data)
                live_workers -= 1
                log(f"[cluster] worker failed ({data}); {live_workers} remain")
                if live_workers == 0:
                    raise RuntimeError(
                        "all render nodes failed: " + "; ".join(errors))
                continue
            accum = data if accum is None else accum + data
            n_done += cnt
            log(f"[cluster] {n_done}/{spp} spp")
    finally:
        done_flag.set()
    for t in threads:
        t.join(timeout=30)

    proto = make_film(settings.width, settings.height, settings.rfilter,
                      settings.rfilter_radius)
    film = Film(data=accum, width=settings.width, height=settings.height,
                ftype=proto.ftype, radius=proto.radius)
    return np.asarray(develop(film))
