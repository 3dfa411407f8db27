"""Codec model families (the ``WEBRTC_ENCODER`` element equivalents)."""

from .base import EncodedFrame, Encoder  # noqa: F401
from .h264 import H264Encoder, resolve_device  # noqa: F401
from .mjpeg import JpegEncoder  # noqa: F401


def make_flagship_encoder(width: int, height: int, device=None):
    """The bench's headline encoder, as the reference's: H.264 CAVLC with
    device entropy and host colour, all-intra (``gop=1``), on the card
    unless ``device`` says otherwise.  Returns (encoder, codec_name)."""
    return (H264Encoder(width, height, mode="cavlc", entropy="device",
                        host_color=True, device=device),
            "h264_cavlc")


def make_encoder(cfg, width: int, height: int, device=None,
                 spatial_devices=None):
    """Codec from the config surface (WEBRTC_ENCODER + ENCODER_* knobs),
    on the card unless ``device`` says otherwise.  Returns (encoder,
    codec_name).  ``tpuh264enc`` (every ``ENCODER_ENTROPY`` and
    ``ENCODER_INTRA_MODES`` the reference serves) and ``tpumjpegenc`` are
    ported; ``tpuvp8enc`` raises NotImplementedError.  ``spatial_devices``: the devices
    ``ENCODER_SPATIAL_SHARDS`` counts and shards over (see
    :class:`H264Encoder`)."""
    codec = cfg.codec
    if codec == "tpuh264enc":
        entropy = cfg.encoder_entropy
        if entropy not in ("device", "cabac", "native", "python"):
            raise ValueError(f"unknown ENCODER_ENTROPY {entropy!r}")
        enc = H264Encoder(width, height, qp=cfg.encoder_qp, mode="cavlc",
                          entropy=entropy, host_color=True,
                          gop=cfg.encoder_gop,
                          bitrate_kbps=cfg.encoder_bitrate_kbps,
                          fps=cfg.refresh, deblock=True,
                          intra_modes=cfg.encoder_intra_modes,
                          superstep_chunk=cfg.encoder_chunk,
                          spatial_shards=getattr(
                              cfg, "encoder_spatial_shards", None),
                          tune=getattr(cfg, "encoder_tune", None),
                          device=device, spatial_devices=spatial_devices)
        return enc, f"h264_{'cabac' if entropy == 'cabac' else 'cavlc'}"
    if codec == "tpumjpegenc":
        return JpegEncoder(width, height, device=device), "mjpeg"
    if codec == "tpuvp8enc":
        raise NotImplementedError(
            f"{codec} is not ported to the PyTorch/CUDA package yet "
            "(ROADMAP queue 1 item 13)")
    raise ValueError(f"unknown WEBRTC_ENCODER {cfg.webrtc_encoder!r} "
                     f"(resolved: {codec!r})")
