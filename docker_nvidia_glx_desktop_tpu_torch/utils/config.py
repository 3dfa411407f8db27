"""Environment-variable configuration surface.

Parity with the reference's pure-env config system (SURVEY.md §2.4; reference
Dockerfile:200-212, entrypoint.sh, selkies-gstreamer-entrypoint.sh:18-30,
xgl.yml:25-109).  Every non-NVIDIA variable keeps its reference name, default
and defaulting chain (e.g. ``BASIC_AUTH_PASSWORD`` falls back to ``PASSWD``,
reference selkies-gstreamer-entrypoint.sh:20).  NVIDIA-only knobs
(``NVIDIA_*``, ``VIDEO_PORT``, ``__GL_SYNC_TO_VBLANK``) are accepted but
ignored with a warning, so existing deployments keep working.  TPU-side knobs
(mesh spec, encoder tuning) are new — the reference delegated encoder tuning
to selkies CLI flags (selkies-gstreamer-entrypoint.sh:47).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Mapping, Optional

log = logging.getLogger(__name__)

# Reference env vars that no longer do anything on a TPU VM (SURVEY.md §2.4).
_IGNORED_VARS = (
    "NVIDIA_VISIBLE_DEVICES",
    "NVIDIA_DRIVER_CAPABILITIES",
    "VIDEO_PORT",
    "__GL_SYNC_TO_VBLANK",
)

# Legacy encoder names (reference Dockerfile:210) -> our codec names.
_ENCODER_ALIASES = {
    "nvh264enc": "tpuh264enc",   # NVENC H.264 -> TPU H.264
    "x264enc": "tpuh264enc",
    "vp8enc": "tpuvp8enc",
    "vp9enc": "tpuvp8enc",       # VP9 not yet implemented; VP8 is nearest
}

_TRUE = {"true", "1", "yes", "on"}

# Warn-once latch for the vp9enc fallback: cfg.codec is re-read on every
# request/stats/metrics path, and a computed property must stay pure —
# the side effect (one log line) lives here instead (ADVICE round 5).
_vp9_warned = False


def _warn_vp9_once() -> None:
    global _vp9_warned
    if _vp9_warned:
        return
    _vp9_warned = True
    # no silent phantom codecs: the client
    # negotiates what the bitstream actually is
    log.warning(
        "WEBRTC_ENCODER=vp9enc: VP9 is not implemented; serving "
        "VP8 instead (the client sees and negotiates VP8). "
        "See README 'Encoder support matrix'.")


def _as_bool(val: str) -> bool:
    # The reference compares lowercased strings (entrypoint.sh:87,121 idiom
    # ``${VAR,,}``); we accept the same spellings.
    return val.strip().lower() in _TRUE


@dataclasses.dataclass
class Config:
    """Resolved runtime configuration for one streaming session."""

    # --- display geometry (reference Dockerfile:202-206) ---
    display: str = ":0"
    sizew: int = 1920
    sizeh: int = 1080
    refresh: int = 60
    dpi: int = 96
    cdepth: int = 24

    # --- auth / access (reference Dockerfile:208-212, entrypoint.sh:120-125) ---
    passwd: str = "mypasswd"
    basic_auth_password: str = ""          # <- PASSWD when unset
    enable_basic_auth: bool = True
    novnc_enable: bool = False
    novnc_viewpass: str = ""

    # --- encoder selection (reference Dockerfile:210-211) ---
    webrtc_encoder: str = "tpuh264enc"
    webrtc_enable_resize: bool = False

    # --- streaming web app (reference selkies-gstreamer-entrypoint.sh:27-38) ---
    pwa_app_name: str = "TPU Desktop Streaming Platform"
    pwa_app_short_name: str = "TPUDesktop"
    pwa_start_url: str = "/index.html"
    listen_addr: str = "0.0.0.0"
    listen_port: int = 8080                # reference Dockerfile:535 EXPOSE 8080

    # --- HTTPS (reference xgl.yml:68-74) ---
    enable_https_web: bool = False
    https_web_cert: str = "/etc/ssl/certs/ssl-cert-snakeoil.pem"
    https_web_key: str = "/etc/ssl/private/ssl-cert-snakeoil.key"

    # --- TURN / NAT traversal (reference xgl.yml:85-109, README.md:65-143) ---
    turn_host: str = ""
    turn_port: int = 3478
    turn_shared_secret: str = ""
    turn_username: str = ""
    turn_password: str = ""
    turn_protocol: str = "udp"
    turn_tls: bool = False

    # --- audio (reference Dockerfile:17, supervisord.conf:24) ---
    pulse_server: str = "unix:/run/pulse/native"
    pulse_port: int = 4713
    audio_codec: str = "opus"     # "opus" (libopus) | "pcm" (raw s16le)
    audio_bitrate: int = 128_000  # opus target, bits/s

    # --- misc environment (reference Dockerfile:15-36, 201) ---
    tz: str = "UTC"
    lang: str = "en_US.UTF-8"
    xdg_runtime_dir: str = "/tmp/runtime-user"

    # --- TPU-side knobs (new; no reference equivalent) ---
    tpu_mesh: str = "1"           # device mesh spec, e.g. "1", "8", "2x4"
    tpu_sessions: int = 1         # concurrent sessions batch-encoded per host
    # per-session geometries "WxH,WxH,..." (empty = every session uses
    # SIZEW x SIZEH); mixed values are bucketed by padded geometry, one
    # compiled batch step per bucket (web/multisession.py)
    tpu_session_sizes: str = ""
    encoder_qp: int = 26          # H.264 QP / quality knob
    encoder_gop: int = 60         # keyframe interval (frames); resume => IDR
    encoder_bitrate_kbps: int = 8000
    # background-compile the rate ladder's qp set at session start so the
    # first scene cut never stalls on a fresh XLA compile
    encoder_prewarm: bool = True
    # entropy coder: "device" (TPU CAVLC — only packed bytes cross the
    # host link; the serving default), "cabac" (host C++ CABAC, Main
    # profile, ~0.85x the bytes — costs a level-tensor pull per frame,
    # best on PCIe-attached chips or bitrate-constrained links),
    # "native"/"python" (host CAVLC debug paths)
    encoder_entropy: str = "device"
    # intra mode search: "auto" (fast sets: I16 DC/H + I4x4 left/vertical
    # families) or "full" (nine-mode I4x4 — ~2x intra sequential depth
    # for measurably fewer bits on window-chrome content)
    encoder_intra_modes: str = "auto"
    # GOP-chunk super-step (ops/devloop.ChunkStep): stage this many P
    # frames and run them as ONE replay of a captured CUDA graph — one
    # dispatch per chunk instead of a dozen launches per frame, at
    # chunk-1 frames of added pipeline latency.  0 = per-frame dispatch.
    # Best with ENCODER_GOP = k*chunk + 1 so whole P-runs chunk evenly.
    encoder_chunk: int = 0
    # Spatial mesh sharding of ONE session's frame (resolution ladder):
    # "0"/"1" = off, an integer = that many MB-row shards (clamped to
    # what the geometry divides into, parallel/batch.
    # feasible_spatial_shards), "auto" = shard when the geometry's
    # modeled per-chip cost (fleet/capacity) exceeds the active SLO
    # rung's budget — one 4K session spreads across the chips the model
    # says it needs instead of missing 4K30 on one.
    encoder_spatial_shards: str = "0"
    # Perceptual-efficiency tuning tier (ops/aq, ROADMAP item 4):
    # "off" = pre-tune encoder, byte-identical output; "hq" = per-MB
    # adaptive quantization + Lagrangian (lambda) mode decisions +
    # 1-frame lookahead on the chunk ring — more device cycles per
    # frame (bounded <=1.5x the off step in CI) for measurably fewer
    # bits at equal quality (bench.py --bdrate).  VP8 hq adds golden-
    # frame refresh + quarter-pel sixtap ME re-rank.
    encoder_tune: str = "off"
    gst_debug: str = "*:2"        # kept for pipeline-debug parity (ref :18)
    # /healthz reports unhealthy after this many seconds without a frame.
    # The reference's noVNC heartbeat is 10 s (entrypoint.sh:124); 30 s
    # default keeps slack for jit-compile warmup on geometry changes.
    healthz_stall_s: float = 30.0
    # SLO-driven degradation ladder (resilience/degrade): shed quality
    # (IDR -> qp -> fps -> resolution) on sustained budget breach
    # instead of missing deadlines; DEGRADE_ENABLE=false turns the
    # controller off entirely (README "Failure modes").
    degrade_enable: bool = True
    degrade_interval_s: float = 1.0
    # Session-continuity checkpointing (resilience/continuity): snapshot
    # the encoder's host-side state every DNGD_CKPT_INTERVAL seconds so a
    # device preemption/reset restores the same stream lineage (SSRC,
    # sequence, timestamps) via a recovery IDR instead of tearing the
    # session down.  0 disables (recovery still works, minus the lineage).
    ckpt_interval_s: float = 5.0
    # Graceful drain (SIGTERM / POST /debug/drain): how long to keep
    # serving connected clients — so they can pre-connect elsewhere after
    # the ("draining") control item — before the process exits.
    drain_grace_s: float = 8.0
    # Zero-downtime handoff (resilience/handoff): when DNGD_HANDOFF_DIR
    # is set, SIGTERM / POST /debug/drain MIGRATES connected sessions —
    # spooling a versioned snapshot (encoder checkpoint + wire
    # continuity) that a restart-in-place successor imports, handing
    # each client a resume token — instead of shedding them.  Empty
    # disables (legacy drain-and-shed).
    handoff_dir: str = ""
    # Alternative transport for host replacement: stream the snapshot
    # to a warm successor listening on this unix socket path.
    handoff_sock: str = ""
    # How long an unredeemed resume token stays claimable on the
    # successor before it expires (counts as a failed handoff).
    handoff_token_ttl_s: float = 45.0
    # Fleet admission & overload protection (fleet/): capacity-aware
    # session scheduler between /ws and the batch managers.  Off by
    # default — a single-desktop pod admits like the reference did; the
    # multi-session fleet bench and production multi-tenant deployments
    # turn it on (README "Capacity & admission").
    fleet_enable: bool = False
    # 0 = derive capacity from the ledger-fed cost model
    # (fleet/capacity); >0 pins the concurrent-session ceiling.
    fleet_max_sessions: int = 0
    # >0 pins sessions-per-chip while the fleet TOTAL still scales with
    # the live chip count (so chip loss sheds proportionally); 0 = model.
    fleet_sessions_per_chip: int = 0
    # bounded admission wait queue: joiners past capacity wait here up
    # to FLEET_QUEUE_TIMEOUT_S before a busy/retry_after_s rejection;
    # a full queue rejects immediately.
    fleet_queue_depth: int = 16
    fleet_queue_timeout_s: float = 10.0
    # base of the retry_after_s hint in busy rejections (stretched by
    # queue depth server-side; jittered client-side via the
    # resilience/policy full-jitter formula).
    fleet_retry_after_s: float = 2.0
    # queue-depth backpressure walks the degrade ladder fleet-wide up
    # to this rung before any session is shed (0 disables).
    fleet_backpressure_level: int = 2

    # ------------------------------------------------------------------

    @property
    def effective_basic_auth_password(self) -> str:
        """``BASIC_AUTH_PASSWORD`` falling back to ``PASSWD``.

        Reference selkies-gstreamer-entrypoint.sh:20:
        ``export BASIC_AUTH_PASSWORD="${BASIC_AUTH_PASSWORD:-$PASSWD}"``.
        """
        return self.basic_auth_password or self.passwd

    @property
    def codec(self) -> str:
        """Normalised codec name: ``tpuh264enc``/``tpuvp8enc``/``tpumjpegenc``."""
        if self.webrtc_encoder == "vp9enc":
            _warn_vp9_once()
        return _ENCODER_ALIASES.get(self.webrtc_encoder, self.webrtc_encoder)

    @property
    def mesh_shape(self) -> tuple:
        """Parse ``TPU_MESH`` ("8" or "2x4") into a mesh shape tuple."""
        spec = self.tpu_mesh.strip().lower()
        if not spec:
            return (1,)
        try:
            return tuple(int(p) for p in spec.split("x"))
        except ValueError:
            log.warning("TPU_MESH=%r is not a valid mesh spec (e.g. '8' or "
                        "'2x4'); using single-device mesh", self.tpu_mesh)
            return (1,)

    def session_sizes(self) -> list:
        """Per-session (w, h) list of length ``tpu_sessions``.

        Parsed from ``TPU_SESSION_SIZES`` ("1920x1080,1280x720,..."); the
        list is padded with (sizew, sizeh) when shorter, truncated when
        longer; malformed entries fall back to the global geometry."""
        out = []
        spec = self.tpu_session_sizes.strip()
        if spec:
            for part in spec.split(",")[:self.tpu_sessions]:
                try:
                    w, h = (int(v) for v in part.lower().split("x"))
                    if w <= 0 or h <= 0:
                        raise ValueError(part)
                    out.append((w, h))
                except ValueError:
                    log.warning("TPU_SESSION_SIZES entry %r invalid; using "
                                "%dx%d", part, self.sizew, self.sizeh)
                    out.append((self.sizew, self.sizeh))
        while len(out) < self.tpu_sessions:
            out.append((self.sizew, self.sizeh))
        return out

    def resolution(self) -> tuple:
        return (self.sizew, self.sizeh)


def from_env(env: Optional[Mapping[str, str]] = None) -> Config:
    """Build a :class:`Config` from an environment mapping (default ``os.environ``)."""
    env = os.environ if env is None else env
    for var in _IGNORED_VARS:
        if var in env:
            log.warning(
                "%s is set but has no effect on a TPU VM (no GPU in the loop); "
                "ignoring for compatibility with docker-nvidia-glx-desktop", var
            )

    def s(name: str, default: str) -> str:
        return env.get(name, default)

    def i(name: str, default: int) -> int:
        raw = env.get(name)
        if raw is None or raw == "":
            return default
        try:
            return int(raw)
        except ValueError:
            log.warning("%s=%r is not an integer; using default %s", name, raw, default)
            return default

    def b(name: str, default: bool) -> bool:
        raw = env.get(name)
        return default if raw is None else _as_bool(raw)

    def fl(name: str, default: float) -> float:
        raw = env.get(name)
        if raw is None or raw == "":
            return default
        try:
            return float(raw)
        except ValueError:
            log.warning("%s=%r is not a number; using default %s", name, raw,
                        default)
            return default

    return Config(
        display=s("DISPLAY", ":0"),
        sizew=i("SIZEW", 1920),
        sizeh=i("SIZEH", 1080),
        refresh=i("REFRESH", 60),
        dpi=i("DPI", 96),
        cdepth=i("CDEPTH", 24),
        passwd=s("PASSWD", "mypasswd"),
        basic_auth_password=s("BASIC_AUTH_PASSWORD", ""),
        enable_basic_auth=b("ENABLE_BASIC_AUTH", True),
        novnc_enable=b("NOVNC_ENABLE", False),
        novnc_viewpass=s("NOVNC_VIEWPASS", ""),
        webrtc_encoder=s("WEBRTC_ENCODER", "tpuh264enc"),
        webrtc_enable_resize=b("WEBRTC_ENABLE_RESIZE", False),
        pwa_app_name=s("PWA_APP_NAME", "TPU Desktop Streaming Platform"),
        pwa_app_short_name=s("PWA_APP_SHORT_NAME", "TPUDesktop"),
        pwa_start_url=s("PWA_START_URL", "/index.html"),
        listen_addr=s("LISTEN_ADDR", "0.0.0.0"),
        listen_port=i("LISTEN_PORT", 8080),
        enable_https_web=b("ENABLE_HTTPS_WEB", False),
        https_web_cert=s("HTTPS_WEB_CERT", "/etc/ssl/certs/ssl-cert-snakeoil.pem"),
        https_web_key=s("HTTPS_WEB_KEY", "/etc/ssl/private/ssl-cert-snakeoil.key"),
        turn_host=s("TURN_HOST", ""),
        turn_port=i("TURN_PORT", 3478),
        turn_shared_secret=s("TURN_SHARED_SECRET", ""),
        turn_username=s("TURN_USERNAME", ""),
        turn_password=s("TURN_PASSWORD", ""),
        turn_protocol=s("TURN_PROTOCOL", "udp"),
        turn_tls=b("TURN_TLS", False),
        pulse_server=s("PULSE_SERVER", "unix:/run/pulse/native"),
        pulse_port=i("PULSE_PORT", 4713),
        audio_codec=s("AUDIO_CODEC", "opus").strip().lower(),
        audio_bitrate=i("AUDIO_BITRATE", 128_000),
        tz=s("TZ", "UTC"),
        lang=s("LANG", "en_US.UTF-8"),
        xdg_runtime_dir=s("XDG_RUNTIME_DIR", "/tmp/runtime-user"),
        tpu_mesh=s("TPU_MESH", "1"),
        tpu_sessions=i("TPU_SESSIONS", 1),
        tpu_session_sizes=s("TPU_SESSION_SIZES", ""),
        encoder_qp=i("ENCODER_QP", 26),
        encoder_gop=i("ENCODER_GOP", 60),
        encoder_bitrate_kbps=i("ENCODER_BITRATE_KBPS", 8000),
        encoder_prewarm=b("ENCODER_PREWARM", True),
        encoder_entropy=env.get("ENCODER_ENTROPY", "device"),
        encoder_intra_modes=env.get("ENCODER_INTRA_MODES", "auto"),
        encoder_chunk=i("ENCODER_SUPERSTEP_CHUNK", 0),
        encoder_spatial_shards=s("ENCODER_SPATIAL_SHARDS", "0"),
        encoder_tune=s("ENCODER_TUNE", "off").strip().lower() or "off",
        gst_debug=s("GST_DEBUG", "*:2"),
        healthz_stall_s=fl("HEALTHZ_STALL_S", 30.0),
        degrade_enable=b("DEGRADE_ENABLE", True),
        degrade_interval_s=fl("DEGRADE_INTERVAL_S", 1.0),
        ckpt_interval_s=fl("DNGD_CKPT_INTERVAL", 5.0),
        drain_grace_s=fl("DNGD_DRAIN_GRACE_S", 8.0),
        handoff_dir=s("DNGD_HANDOFF_DIR", ""),
        handoff_sock=s("DNGD_HANDOFF_SOCK", ""),
        handoff_token_ttl_s=fl("DNGD_HANDOFF_TOKEN_TTL_S", 45.0),
        fleet_enable=b("FLEET_ENABLE", False),
        fleet_max_sessions=i("FLEET_MAX_SESSIONS", 0),
        fleet_sessions_per_chip=i("FLEET_SESSIONS_PER_CHIP", 0),
        fleet_queue_depth=i("FLEET_QUEUE_DEPTH", 16),
        fleet_queue_timeout_s=fl("FLEET_QUEUE_TIMEOUT_S", 10.0),
        fleet_retry_after_s=fl("FLEET_RETRY_AFTER_S", 2.0),
        fleet_backpressure_level=i("FLEET_BACKPRESSURE_LEVEL", 2),
    )
