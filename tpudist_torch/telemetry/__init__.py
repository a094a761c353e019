"""Telemetry of the PyTorch port (this slice: the JSONL sink)."""

from tpudist_torch.telemetry.sink import TelemetrySink, _json_safe

__all__ = ["TelemetrySink", "_json_safe"]
