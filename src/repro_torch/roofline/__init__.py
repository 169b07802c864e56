"""Roofline terms and analytic scaling curves (``analysis.py``)."""

from repro_torch.roofline.analysis import (
    collective_bytes_from_hlo,
    roofline_terms,
    RooflineReport,
)

__all__ = ["collective_bytes_from_hlo", "roofline_terms", "RooflineReport"]
