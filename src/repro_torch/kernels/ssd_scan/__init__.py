from repro_torch.kernels.ssd_scan.ops import LAUNCHES, ssd_scan, ssd_scan_plain
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_ref

__all__ = ["LAUNCHES", "ssd_chunked", "ssd_scan", "ssd_scan_plain",
           "ssd_scan_ref"]
