"""Zero-downtime process lifecycle: live session handoff.

Continuity (``resilience/continuity``) makes the encoder state survive a
*device*; this module makes the whole session survive the *process*.  A deploy (SIGTERM, ``POST
/debug/drain``) no longer sheds the connected population: the dying
process exports one versioned, self-describing snapshot per live
connection — the encoder checkpoint (``export_state``, schema-stamped
by models/base) plus the wire continuity set (SSRC + RTP seq frontier
per stream, SRTP ROC/rollover state per SSRC, SCTP TSN/SSN counters,
journey/recovery counters, fleet tier) — and either spools it to
``DNGD_HANDOFF_DIR`` (restart-in-place) or streams it over a local
unix socket (``DNGD_HANDOFF_SOCK``, host replacement with a warm
successor).  Each client is told ``{"type": "migrate", "resume":
<token>}``; the successor imports the snapshot, re-admits the resume
token through the fleet scheduler at the recorded tier (queue
bypassed — the session already *had* capacity), and the reconnected
client sees exactly one recovery IDR on the same SSRC with contiguous
RTP sequence numbers.

Wire-format notes: the snapshot is tagged JSON, not pickle — the
trust-boundary rule (never feed an untrusted deserializer)
holds even on a local socket, and a self-describing format is what
lets ``import`` reject a schema drift with a clear error instead of a
deep KeyError.  numpy reference planes ride as base64 with dtype and
shape; bytes as base64; tuples are tagged so checkpoints round-trip
``is``-faithfully enough for ``import_state``.

A handoff that cannot complete (encode failure, schema mismatch,
expired token) falls back to the shed path — counted as
``dngd_fleet_shed_total{reason="handoff_failed"}`` and dumped by the
flight recorder (``handoff-failed`` is a trigger kind) so a deploy
that silently degraded into an incident is postmortem-visible.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import secrets
import time
from typing import Callable, Dict, Optional

from ..obs import events as obsev
from ..obs import metrics as obsm

log = logging.getLogger(__name__)

__all__ = ["HANDOFF_SCHEMA", "HandoffError", "HandoffSchemaError",
           "HandoffManager", "encode_snapshot", "decode_snapshot",
           "send_over_socket", "serve_socket"]

# Version of the handoff ENVELOPE (session entries inside additionally
# carry the encoder-checkpoint schema from models/base.CKPT_SCHEMA —
# two independent formats, two independent version stamps).
HANDOFF_SCHEMA = 1

# -- dngd_handoff_* metric families (idempotent at import; server.py
# imports this module eagerly so they are scrape-visible from boot)
# -----------------------------------------------------------------
_M_SESSIONS = obsm.counter(
    "dngd_handoff_sessions_total",
    "Session snapshots through the handoff plane",
    ("result",))            # exported | imported | failed
_M_RESUME = obsm.counter(
    "dngd_handoff_resume_total",
    "Resume-token redemptions on the successor",
    ("result",))            # resumed | expired | unknown
_H_EXPORT_MS = obsm.histogram(
    "dngd_handoff_export_ms",
    "Wall time to snapshot + serialize one process's live sessions")
_H_IMPORT_MS = obsm.histogram(
    "dngd_handoff_import_ms",
    "Wall time to decode + adopt a predecessor's snapshot")
_G_SNAPSHOT_BYTES = obsm.gauge(
    "dngd_handoff_snapshot_bytes",
    "Size of the last handoff snapshot written or received")
_G_PENDING = obsm.gauge(
    "dngd_handoff_pending_tokens",
    "Imported resume tokens not yet redeemed by a reconnecting client")


def count_session(result: str) -> None:
    """Account one session through the handoff plane
    (``exported`` | ``imported`` | ``failed``) — exposed as a helper so
    the session's encode thread can count without importing metric
    internals."""
    _M_SESSIONS.labels(result).inc()


class HandoffError(RuntimeError):
    """A handoff step failed; the caller falls back to shed."""


class HandoffSchemaError(HandoffError):
    """Snapshot schema/codec mismatch — rejected with a clear error
    instead of a deep KeyError inside ``import_state``."""


# -- tagged-JSON snapshot codec ------------------------------------------

def _pack(obj):
    """JSON-able view of a checkpoint value tree.  Self-describing:
    numpy arrays carry dtype+shape, bytes are tagged base64, tuples are
    tagged lists (``import_state`` implementations index into tuples)."""
    import numpy as np

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, bytes):
        return {"__b64__": base64.b64encode(obj).decode()}
    if isinstance(obj, np.ndarray):
        return {"__nd__": {"dtype": str(obj.dtype),
                           "shape": list(obj.shape),
                           "data": base64.b64encode(
                               np.ascontiguousarray(obj).tobytes()
                           ).decode()}}
    if isinstance(obj, np.generic):          # numpy scalar
        return obj.item()
    if isinstance(obj, tuple):
        return {"__tup__": [_pack(v) for v in obj]}
    if isinstance(obj, list):
        return [_pack(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): _pack(v) for k, v in obj.items()}
    # device arrays still reachable (a checkpoint taken mid-death):
    # pull to host rather than refuse the whole handoff
    if hasattr(obj, "__array__"):
        return _pack(np.asarray(obj))
    raise HandoffError(
        f"checkpoint value of type {type(obj).__name__} is not "
        "snapshot-serializable")


def _unpack(obj):
    import numpy as np

    if isinstance(obj, dict):
        if "__b64__" in obj and len(obj) == 1:
            return base64.b64decode(obj["__b64__"])
        if "__nd__" in obj and len(obj) == 1:
            nd = obj["__nd__"]
            arr = np.frombuffer(base64.b64decode(nd["data"]),
                                dtype=np.dtype(nd["dtype"]))
            return arr.reshape(nd["shape"]).copy()
        if "__tup__" in obj and len(obj) == 1:
            return tuple(_unpack(v) for v in obj["__tup__"])
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v) for v in obj]
    return obj


def encode_snapshot(snapshot: dict) -> bytes:
    """Envelope + tagged-JSON serialization of a handoff snapshot."""
    body = {"schema": HANDOFF_SCHEMA,
            "created": time.time(),
            "pid": os.getpid(),
            "snapshot": _pack(snapshot)}
    return json.dumps(body, separators=(",", ":")).encode()


def decode_snapshot(data: bytes) -> dict:
    """Validate the envelope and return the snapshot dict.  Raises
    :class:`HandoffSchemaError` on a version the successor does not
    speak — the clear-rejection contract."""
    try:
        body = json.loads(data.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise HandoffError(f"handoff snapshot is not valid JSON: {e}")
    if not isinstance(body, dict):
        raise HandoffError("handoff snapshot envelope is not an object")
    schema = body.get("schema")
    if schema != HANDOFF_SCHEMA:
        raise HandoffSchemaError(
            f"handoff snapshot schema {schema!r} != supported "
            f"{HANDOFF_SCHEMA} (predecessor pid {body.get('pid')}); "
            "refusing import — sessions fall back to shed")
    return _unpack(body.get("snapshot") or {})


# -- the manager ----------------------------------------------------------

class _LiveConn:
    """One connected client's handoff registration on the PREDECESSOR:
    its admission identity plus the hooks the migrate path needs — a
    wire exporter (the peer's RTP/SRTP/SCTP continuity set) and a
    notifier that delivers the ``migrate`` control message."""

    __slots__ = ("token", "sid", "tier", "wire_fn", "notify")

    def __init__(self, token: str, sid: str, tier: int):
        self.token = token
        self.sid = sid
        self.tier = tier
        self.wire_fn: Optional[Callable[[], dict]] = None
        self.notify: Optional[Callable[[str, float], None]] = None


class HandoffManager:
    """Event-loop-owned broker for both sides of a handoff.

    Predecessor: ``register``/``attach_wire`` track live connections;
    ``export`` builds the snapshot (sessions + connections) the server
    spools or streams.  Successor: ``import_snapshot`` validates and
    stages it; ``claim`` redeems a client's resume token (single-use,
    TTL-bounded) into the staged continuity entry the /ws handler
    re-admits through the fleet scheduler.
    """

    def __init__(self, handoff_dir: str = "", sock_path: str = "",
                 token_ttl_s: float = 45.0,
                 clock: Callable[[], float] = time.monotonic):
        self.dir = handoff_dir or ""
        self.sock_path = sock_path or ""
        self.token_ttl_s = float(token_ttl_s)
        self._clock = clock
        self._live: Dict[str, _LiveConn] = {}
        self._pending: Dict[str, dict] = {}   # token -> staged conn entry
        self._pending_since: Dict[str, float] = {}
        self.exports = 0
        self.imports = 0
        self.failures = 0
        _G_PENDING.set_function(lambda: float(len(self._pending)))

    @property
    def enabled(self) -> bool:
        return bool(self.dir or self.sock_path)

    # -- predecessor side ---------------------------------------------

    def register(self, sid: str, tier: int = 0,
                 notify: Optional[Callable[[str, float], None]] = None
                 ) -> str:
        """A freshly admitted connection joins the handoff set; returns
        the resume token the client carries across the restart."""
        token = secrets.token_urlsafe(16)
        conn = _LiveConn(token, sid, int(tier))
        conn.notify = notify
        self._live[token] = conn
        return token

    def attach_wire(self, token: str,
                    wire_fn: Callable[[], dict]) -> None:
        """Wire-continuity exporter for ``token`` (the WebRTC peer's
        RTP/SRTP/SCTP state; MSE-only connections have none)."""
        conn = self._live.get(token)
        if conn is not None:
            conn.wire_fn = wire_fn

    def detach(self, token: str) -> None:
        """Connection closed normally: it will not be migrated."""
        self._live.pop(token, None)

    def live_count(self) -> int:
        return len(self._live)

    def export(self, sessions) -> dict:
        """Build the process snapshot: one entry per hub (encoder
        checkpoint — the hubs must be STOPPED first, export_state is
        not safe against a running encode thread) + one entry per live
        connection (identity, tier, wire continuity).  Connections
        whose wire exporter raises are dropped from the snapshot (they
        will shed) — a bad peer must not sink everyone's migration."""
        t0 = self._clock()
        session_entries = []
        for i, sess in enumerate(sessions):
            try:
                state = sess.export_handoff()
            except Exception:
                self.failures += 1
                _M_SESSIONS.labels("failed").inc()
                log.exception("handoff export failed for session %d", i)
                obsev.emit("handoff-failed", reason="export_error",
                           index=i)
                continue
            session_entries.append({"index": i, "state": state})
            _M_SESSIONS.labels("exported").inc()
        conn_entries = []
        for conn in list(self._live.values()):
            wire = None
            if conn.wire_fn is not None:
                try:
                    wire = conn.wire_fn()
                except Exception:
                    self.failures += 1
                    log.exception("wire export failed for %s", conn.sid)
                    obsev.emit("handoff-failed", reason="wire_export",
                               session=conn.sid)
                    continue
            conn_entries.append({"token": conn.token, "sid": conn.sid,
                                 "tier": conn.tier, "wire": wire})
        self.exports += 1
        _H_EXPORT_MS.observe((self._clock() - t0) * 1e3)
        return {"sessions": session_entries, "conns": conn_entries}

    def notify_all(self, retry_after_s: float = 1.0) -> int:
        """Tell every live client to reconnect with its resume token."""
        n = 0
        for conn in list(self._live.values()):
            if conn.notify is None:
                continue
            try:
                conn.notify(conn.token, retry_after_s)
                n += 1
            except Exception:
                log.exception("migrate notify failed for %s", conn.sid)
        return n

    def spool(self, snapshot: dict) -> str:
        """Atomically write the snapshot for a restart-in-place
        successor (tmp + rename: the successor never reads a torn
        file).  One file per predecessor pid; the successor consumes
        every file it finds."""
        data = encode_snapshot(snapshot)
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"handoff-{os.getpid()}.json")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        _G_SNAPSHOT_BYTES.set(len(data))
        return path

    # -- successor side -----------------------------------------------

    def import_snapshot(self, snapshot: dict) -> list:
        """Stage a decoded snapshot: resume tokens become claimable;
        returns the session entries for the caller to adopt into its
        hubs.  Schema validation already happened in decode."""
        t0 = self._clock()
        now = self._clock()
        for entry in snapshot.get("conns") or []:
            token = entry.get("token")
            if not token:
                continue
            self._pending[str(token)] = entry
            self._pending_since[str(token)] = now
        sessions = list(snapshot.get("sessions") or [])
        self.imports += 1
        _H_IMPORT_MS.observe((self._clock() - t0) * 1e3)
        obsev.emit("handoff-import",
                   sessions=len(sessions), conns=len(self._pending))
        return sessions

    def load_spool(self) -> list:
        """Consume every spooled snapshot in ``DNGD_HANDOFF_DIR``.
        Each file is deleted once read (claimed or not: a crashed
        import must not replay stale wire state onto a third process).
        Returns the combined session entries."""
        if not self.dir or not os.path.isdir(self.dir):
            return []
        sessions = []
        for name in sorted(os.listdir(self.dir)):
            if not (name.startswith("handoff-")
                    and name.endswith(".json")):
                continue
            path = os.path.join(self.dir, name)
            try:
                with open(path, "rb") as f:
                    data = f.read()
                os.unlink(path)
                snap = decode_snapshot(data)
            except HandoffError as e:
                self.failures += 1
                _M_SESSIONS.labels("failed").inc()
                log.error("handoff spool %s rejected: %s", name, e)
                obsev.emit("handoff-failed", reason="schema_reject",
                           file=name, error=str(e))
                continue
            except OSError:
                log.exception("handoff spool %s unreadable", name)
                continue
            _G_SNAPSHOT_BYTES.set(len(data))
            sessions.extend(self.import_snapshot(snap))
        return sessions

    def claim(self, token: str) -> Optional[dict]:
        """Redeem a resume token: single-use, TTL-bounded.  Returns the
        staged connection entry, or None (and counts why)."""
        self._expire()
        entry = self._pending.pop(token, None)
        self._pending_since.pop(token, None)
        if entry is None:
            _M_RESUME.labels("unknown").inc()
            return None
        _M_RESUME.labels("resumed").inc()
        return entry

    def _expire(self) -> None:
        if self.token_ttl_s <= 0:
            return
        now = self._clock()
        for token, t in list(self._pending_since.items()):
            if now - t > self.token_ttl_s:
                self._pending.pop(token, None)
                self._pending_since.pop(token, None)
                _M_RESUME.labels("expired").inc()
                obsev.emit("handoff-failed", reason="token_expired",
                           session=token[:8])

    def snapshot(self) -> dict:
        """The /debug/handoff status block (and the flight-recorder
        state provider)."""
        return {"enabled": self.enabled,
                "dir": self.dir or None,
                "sock": self.sock_path or None,
                "live_conns": len(self._live),
                "pending_tokens": len(self._pending),
                "exports": self.exports,
                "imports": self.imports,
                "failures": self.failures}


# -- local handoff socket (host replacement: warm successor) --------------

async def send_over_socket(sock_path: str, snapshot: dict) -> None:
    """Stream one snapshot to a successor listening on ``sock_path``."""
    import asyncio

    reader, writer = await asyncio.open_unix_connection(sock_path)
    try:
        writer.write(encode_snapshot(snapshot))
        writer.write_eof()
        await writer.drain()
        # successor acks with a single byte once staged — without it a
        # predecessor could exit while the kernel still buffers the tail
        await asyncio.wait_for(reader.read(1), timeout=10.0)
    finally:
        writer.close()


async def serve_socket(manager: HandoffManager,
                       on_sessions: Callable[[list], None]):
    """Successor side: listen on ``manager.sock_path`` and stage every
    snapshot a dying predecessor streams over.  Returns the asyncio
    server (caller owns close())."""
    import asyncio

    path = manager.sock_path
    try:
        os.unlink(path)
    except OSError:
        pass

    async def _handle(reader, writer):
        try:
            data = await reader.read()
            sessions = manager.import_snapshot(decode_snapshot(data))
            _G_SNAPSHOT_BYTES.set(len(data))
            on_sessions(sessions)
            writer.write(b"\x01")
            await writer.drain()
        except HandoffError as e:
            manager.failures += 1
            _M_SESSIONS.labels("failed").inc()
            log.error("handoff socket snapshot rejected: %s", e)
            obsev.emit("handoff-failed", reason="schema_reject",
                       error=str(e))
        except Exception:
            log.exception("handoff socket receive failed")
        finally:
            writer.close()

    return await asyncio.start_unix_server(_handle, path=path)
