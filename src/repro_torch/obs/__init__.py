"""Telemetry of the port: the metric taps of the reduce (``obs.taps``).

The recording side of the JAX package's ``repro.obs`` (events, registry,
tracing, report, provenance, ``TelemetryRun``) is not ported yet.
"""

from repro_torch.obs import taps

__all__ = ["taps"]
