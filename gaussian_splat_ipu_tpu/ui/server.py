"""Remote UI server: TCP packet protocol for interactive viewing.

Rebuild of the reference InterfaceServer
(include/remote_ui/InterfaceServer.hpp): a TCP server thread exchanging
typed packets with a remote viewer. The reference uses its packetcomms
submodule (binary mux) + FFmpeg video packets; we use a dependency-free
length-prefixed framing — each packet is

    [4-byte big-endian payload length][4-byte big-endian type length]
    [type name utf-8][payload bytes]

with JSON payloads for control packets and compressed image bytes for
frames — JPEG when PIL is available (the reference's lossy FFmpeg video
role), PNG otherwise; clients dispatch on the payload magic. The packet
vocabulary mirrors the reference's (InterfaceServer.hpp:24-43):
stop, detach, env_rotation, exposure, gamma, X, Y, Z (translation),
lambda1/lambda2 (rot x/y), fov, device, ready, tile_histogram,
render_preview.

State handling is consume-based exactly like the reference
(InterfaceServer.hpp:230-251): getState() marks the state consumed so the
render loop can tell fresh input from stale.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import socket
import struct
import threading
from typing import Optional

import numpy as np

from gaussian_splat_ipu_tpu.utils import image as image_util

log = logging.getLogger("gsplat")


@dataclasses.dataclass
class UiState:
    """Consumable UI state (InterfaceServer.hpp:230-244 parity)."""

    fov: float = np.radians(40.0)
    rot_x_deg: float = 0.0       # reference lambda1
    rot_y_deg: float = 0.0       # reference lambda2
    env_rotation_x: float = 0.0
    env_rotation_y: float = 0.0
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    exposure: float = 1.0
    gamma: float = 1.0
    device: str = "gpu"
    stop: bool = False
    detach: bool = False
    consumed: bool = True


def _send_packet(sock: socket.socket, ptype: str, payload: bytes) -> None:
    name = ptype.encode()
    sock.sendall(struct.pack(">II", len(payload), len(name)) + name
                 + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_packet(sock: socket.socket):
    plen, nlen = struct.unpack(">II", _recv_exact(sock, 8))
    ptype = _recv_exact(sock, nlen).decode()
    payload = _recv_exact(sock, plen)
    return ptype, payload


class InterfaceServer:
    """TCP UI server. start() spawns the accept/receive thread; the render
    loop polls state_changed()/consume_state() and pushes frames with
    send_preview_image()/send_histogram()."""

    def __init__(self, port: int):
        self.port = port
        self._state = UiState()
        self._lock = threading.Lock()
        self._client: Optional[socket.socket] = None
        self._server: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        from gaussian_splat_ipu_tpu.ui.stream import VideoEncoder
        self._encoder = VideoEncoder()
        self._encoder_client = None
        self._detach_requester: Optional[socket.socket] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("0.0.0.0", self.port))
        self._server.listen(1)
        self._server.settimeout(0.5)
        self._thread = threading.Thread(target=self._communicate,
                                        daemon=True)
        self._thread.start()
        log.info("UI server listening on :%d", self.port)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        for s in (self._client, self._server):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    def connected(self) -> bool:
        return self._client is not None

    def drop_client(self) -> None:
        """Destroy the DETACH REQUESTER's connection but keep serving
        (reference detach semantics, InterfaceServer.hpp:26-27): the
        accept loop stays alive, so a viewer can reconnect later — the
        video encoder emits a fresh keyframe for it.

        The render loop consumes the detach event asynchronously, so by
        the time it calls here the requester may already have hung up and
        a NEW viewer connected; dropping whoever is current would kick
        the newcomer. Only the socket that sent the packet is closed."""
        requester, self._detach_requester = self._detach_requester, None
        if requester is None or requester is not self._client:
            return  # requester already disconnected on its own
        self._client = None
        try:
            requester.close()
        except OSError:
            pass
        log.info("UI client detached")

    # -- state (consume semantics, InterfaceServer.hpp:246-251) ------------
    def state_changed(self) -> bool:
        with self._lock:
            return not self._state.consumed

    def consume_state(self) -> UiState:
        with self._lock:
            snap = dataclasses.replace(self._state)
            self._state.consumed = True
            # detach is an EVENT, not a level: the reference app acts on
            # it once and the next consume must not re-trigger it
            # (InterfaceServer.hpp:24-43 detach packet semantics).
            self._state.detach = False
        return snap

    # -- outgoing telemetry --------------------------------------------
    def send_ready(self) -> None:
        self._send("ready", b"{}")

    def send_preview_image(self, image, exposure: float = 1.0,
                           gamma: float = 1.0) -> None:
        """Encode the framebuffer and push it (the reference pushes FFmpeg
        video packets, InterfaceServer.hpp:322-328; we push compressed
        still frames: JPEG when PIL is available — the lossy low-bandwidth
        stream role — else the dependency-free PNG). Clients distinguish
        by the payload magic bytes."""
        arr = image_util.to_uint8(np.asarray(image), exposure, gamma)
        payload = image_util.encode_jpeg(arr)
        if payload is None:
            payload = image_util.encode_png(arr)
        self._send("render_preview", payload)

    def send_video_frame(self, image, exposure: float = 1.0,
                         gamma: float = 1.0) -> None:
        """Push one frame of the CONTINUOUS preview stream.

        Unlike send_preview_image (independent stills), frames go through
        a long-lived stateful encoder (ui/stream.py): temporal P-frames
        against the previous frame with periodic JPEG keyframes — the
        role of the reference's persistent FFmpeg encoder
        (InterfaceServer.hpp:100-108,322-328). A newly connected client
        always starts on a keyframe (the encoder resets on accept)."""
        client = self._client
        if client is None:
            return
        if self._encoder_client is not client:
            self._encoder.force_keyframe()
            self._encoder_client = client
        arr = image_util.to_uint8(np.asarray(image), exposure, gamma)
        self._send("render_preview", self._encoder.encode(arr))

    def send_hdr_image(self, image, chunk_bytes: int = 1 << 20) -> None:
        """Chunked raw float32 HDR transfer (the reference's sendImage
        path, InterfaceServer.hpp:335-386): an `hdr_header` JSON packet
        announcing shape/chunk count, then `hdr_chunk` packets of raw
        f32 bytes — lossless, for capture/debug rather than preview."""
        arr = np.ascontiguousarray(np.asarray(image, np.float32))
        raw = arr.tobytes()
        nchunks = max(-(-len(raw) // chunk_bytes), 1)
        self._send("hdr_header", json.dumps(
            {"shape": list(arr.shape), "dtype": "float32",
             "chunks": nchunks, "chunk_bytes": chunk_bytes}).encode())
        for i in range(nchunks):
            self._send("hdr_chunk",
                       raw[i * chunk_bytes:(i + 1) * chunk_bytes])

    def send_histogram(self, counts, overflow: int = 0,
                       truncated: int = 0,
                       exchange_overflow: int = 0) -> None:
        """Per-tile pair counts plus drop telemetry: `overflow` pairs lost
        to the fixed pair table, `truncated` past the per-tile work bound,
        `exchange_overflow` splat rows dropped at the all_to_all bucket
        capacity on the distributed path (all 0 when nothing dropped —
        guarded-overflow discipline, codelets.cpp:487-490)."""
        payload = json.dumps(
            {"counts": np.asarray(counts).tolist(),
             "overflow": int(overflow),
             "truncated": int(truncated),
             "exchange_overflow": int(exchange_overflow)}).encode()
        self._send("tile_histogram", payload)

    def _send(self, ptype: str, payload: bytes) -> None:
        client = self._client
        if client is None:
            return
        try:
            _send_packet(client, ptype, payload)
        except OSError:
            log.info("UI client disconnected (send)")
            self._client = None

    # -- receive loop --------------------------------------------------
    def _communicate(self) -> None:
        while not self._stop.is_set():
            try:
                client, addr = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            log.info("UI client connected from %s", addr)
            client.settimeout(0.5)
            self._client = client
            self.send_ready()
            while not self._stop.is_set():
                try:
                    ptype, payload = _recv_packet(client)
                except socket.timeout:
                    continue
                except (ConnectionError, OSError):
                    log.info("UI client disconnected")
                    self._client = None
                    break
                self._handle(ptype, payload)

    def _handle(self, ptype: str, payload: bytes) -> None:
        try:
            value = json.loads(payload.decode() or "{}")
        except json.JSONDecodeError:
            value = {}
        v = value.get("value")
        with self._lock:
            s = self._state
            if ptype == "stop":
                s.stop = True
            elif ptype == "detach":
                s.detach = True
                self._detach_requester = self._client
            elif ptype == "fov":
                s.fov = float(v)
            elif ptype == "lambda1":
                s.rot_x_deg = float(v)
            elif ptype == "lambda2":
                s.rot_y_deg = float(v)
            elif ptype == "env_rotation_x":
                s.env_rotation_x = float(v)
            elif ptype == "env_rotation_y":
                s.env_rotation_y = float(v)
            elif ptype in ("X", "x"):
                s.x = float(v)
            elif ptype in ("Y", "y"):
                s.y = float(v)
            elif ptype in ("Z", "z"):
                s.z = float(v)
            elif ptype == "exposure":
                s.exposure = float(v)
            elif ptype == "gamma":
                s.gamma = float(v)
            elif ptype == "device":
                s.device = str(v)
            else:
                log.debug("unknown packet type %r", ptype)
                return
            s.consumed = False


class InterfaceClient:
    """Minimal client (for tests and scripted control)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._decoder = None
        self._hdr = None  # (meta, [chunks]) in-flight raw transfer

    def send(self, ptype: str, value=None) -> None:
        payload = json.dumps({"value": value}).encode()
        _send_packet(self.sock, ptype, payload)

    def recv(self):
        return _recv_packet(self.sock)

    def decode_preview(self, payload: bytes):
        """render_preview payload -> (H, W, C) u8 frame or None.

        Handles the continuous GSV1 stream (stateful; P-frames before the
        first keyframe yield None) and legacy JPEG/PNG stills."""
        from gaussian_splat_ipu_tpu.ui import stream as stream_lib
        if stream_lib.is_video_packet(payload):
            if self._decoder is None:
                self._decoder = stream_lib.VideoDecoder()
            return self._decoder.decode(payload)
        if payload[:8] == b"\x89PNG\r\n\x1a\n":
            return image_util.decode_png(payload)
        from PIL import Image
        import io as _bio
        return np.asarray(Image.open(_bio.BytesIO(payload)))

    def feed_hdr(self, ptype: str, payload: bytes):
        """Assemble the chunked raw-HDR transfer; returns the f32 array
        when the last chunk arrives, else None."""
        if ptype == "hdr_header":
            self._hdr = (json.loads(payload.decode()), [])
            return None
        if ptype == "hdr_chunk" and self._hdr is not None:
            meta, chunks = self._hdr
            chunks.append(payload)
            if len(chunks) == meta["chunks"]:
                self._hdr = None
                return np.frombuffer(
                    b"".join(chunks),
                    np.float32).reshape(meta["shape"])
        return None

    def close(self) -> None:
        self.sock.close()
