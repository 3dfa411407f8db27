"""Telemetry planes of the port (content-stats knobs so far)."""
