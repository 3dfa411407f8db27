"""Encoder interface shared by all codec families.

The role the ``WEBRTC_ENCODER`` GStreamer element plays in the reference
(nvh264enc/x264enc/vp8enc/vp9enc, Dockerfile:210): a frame sink producing an
encoded bitstream.  Our codecs split into a jitted TPU stage (transform /
quant / scan) and a host entropy stage, pipelined per frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Schema version of the export_state()/import_state() checkpoint dict.
# Bump whenever a codec's state layout changes incompatibly; import
# refuses a mismatched stamp with a clear error (CheckpointSchemaError)
# instead of a deep KeyError three layers into a restore — the failure
# a rolling upgrade across encoder versions would otherwise hit.
CKPT_SCHEMA = 1


class CheckpointSchemaError(ValueError):
    """Checkpoint schema/codec stamp does not match this encoder."""


@dataclasses.dataclass
class EncodedFrame:
    """One encoded access unit plus metadata for the streaming layer."""

    data: bytes
    keyframe: bool
    frame_index: int
    codec: str                      # "mjpeg" | "h264" | "vp8"
    width: int
    height: int
    encode_ms: Optional[float] = None


class Encoder:
    """Base class: stateful per-session encoder."""

    codec = "none"

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.frame_index = 0

    def encode(self, rgb) -> EncodedFrame:
        """Encode one (H, W, 3) uint8 RGB frame."""
        raise NotImplementedError

    def request_keyframe(self) -> None:
        """Force the next frame to be an IDR/keyframe (resume semantics:
        the reference's 'checkpoint/resume' analog, SURVEY.md §5)."""

    def headers(self) -> bytes:
        """Out-of-band codec config (e.g. H.264 SPS/PPS), empty if inline."""
        return b""

    # Pipelined API (SURVEY.md §3.2 double-buffering): codecs with an async
    # device stage override these; the default degrades to synchronous.

    def encode_submit(self, rgb):
        """Start encoding a frame; returns an opaque token."""
        return ("sync", None, None, True, self.encode(rgb))

    def encode_collect(self, token) -> EncodedFrame:
        """Finish the frame started by :meth:`encode_submit`."""
        return token[4]

    # Dispatch accounting (obs/budget 'dispatch' stage): codecs with a
    # device stage report Python -> device crossings + submit-to-launch
    # gap accrued since the last pop; the session feeds the ledger so
    # crossings-per-frame is a scraped gauge, not a bench-only number.

    def pop_dispatch_sample(self):
        """(crossings, gap_ms) since the last pop, or None when the
        codec keeps no dispatch accounting (pure-host codecs)."""
        return None

    # Frame-journey attribution (obs/journey): codecs running the
    # super-step ring or a spatial mesh report per-collected-frame
    # chunk/shard identity so per-frame device spans can be honestly
    # AMORTIZED (a ring-staged frame cost 0 dispatches; the chunk frame
    # paid for the whole chunk).

    def pop_journey_meta(self):
        """{"chunk_id", "slot", "chunk_len", "shards"} for the last
        collected frame, or None when the codec has no chunk/shard
        structure (per-frame codecs)."""
        return None

    # Frames the serving loop should keep in flight; codecs running a
    # multi-frame super-step ring (models/h264) raise this to chunk+1.
    pipeline_depth = 2

    # Checkpoint/restore (resilience/continuity): host-side state snapshot
    # so a session survives device loss — a replacement encoder of the
    # same geometry imports the checkpoint and continues the SAME stream
    # lineage (frame_index, GOP phase, rate control), resyncing the
    # client with one recovery IDR instead of a teardown.

    def export_state(self) -> dict:
        """Host-only (device-array-free) snapshot of the stream lineage,
        stamped with the checkpoint schema version and codec id so a
        restore on a different process/build can refuse incompatible
        state up front.  Subclasses extend; everything in the dict must
        survive the device that produced it."""
        return {"schema": CKPT_SCHEMA, "codec": self.codec,
                "width": self.width, "height": self.height,
                "frame_index": self.frame_index}

    def import_state(self, state: dict) -> None:
        """Adopt a checkpoint exported by a same-geometry encoder.  The
        next frame is forced to a keyframe (the recovery IDR): reference
        chains may be stale or gone, and the client resynchronizes on it
        without renegotiating.  Raises :class:`CheckpointSchemaError` on
        a schema-version or codec/geometry mismatch — a clear rejection,
        never a deep KeyError mid-restore."""
        schema = state.get("schema")
        if schema != CKPT_SCHEMA:
            raise CheckpointSchemaError(
                f"checkpoint schema {schema!r} != supported {CKPT_SCHEMA} "
                f"(codec stamp {state.get('codec')!r}); refusing import")
        key = (state.get("codec"), state.get("width"), state.get("height"))
        if key != (self.codec, self.width, self.height):
            raise CheckpointSchemaError(
                f"checkpoint {key} does not match encoder "
                f"({self.codec}, {self.width}, {self.height})")
        self.frame_index = int(state.get("frame_index", 0))
        self.request_keyframe()
