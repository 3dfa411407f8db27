"""Resilience layer of the port: the retry/timeout/backoff policy
(:mod:`.policy`), deterministic fault injection (:mod:`.faults`),
session continuity under device loss (:mod:`.continuity`) and the
zero-downtime handoff snapshot (:mod:`.handoff`).  The SLO-driven
degradation ladder and the ingress guards come with the browser layer
(ROADMAP item 6b)."""
