from .ops import mamba_scan
from .ref import selective_scan_ref

__all__ = ["mamba_scan", "selective_scan_ref"]
