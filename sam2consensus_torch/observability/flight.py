"""The flight recorder's trace-context derivation.

Copy of ``trace_id`` from ``sam2consensus_tpu/observability/flight.py``
(pinned by ``tests/test_torch_copies.py``): the serve runner stamps it
into each job's trace meta, its ``sched/trace`` gauge and its manifest's
``lifecycle`` section.  The journal assembler and the scheduler telemetry
of the fleet recorder come with the fleet.
"""

from __future__ import annotations


def trace_id(key: str) -> str:
    """The ONE trace-context derivation: a job's trace id IS its
    journal key (serve/journal.job_key — sha256 over input path +
    output-relevant config, 16 hex chars).  Centralized so every
    stamping site (runner, manifest, exposition, assembler) derives it
    the same way; a future format change happens here only."""
    return str(key)
