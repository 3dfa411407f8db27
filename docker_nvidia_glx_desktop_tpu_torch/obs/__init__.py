"""Telemetry planes of the port: metrics, traces, events, journeys, the
serving-budget ledger, the flight recorder, process stats and the
content plane."""
