"""DP engines: NumPy oracle, XLA paths, CUDA kernel (swa_cuda)."""

from .swa_xla import make_profile, sw_scan, sw_wavefront

__all__ = ["make_profile", "sw_scan", "sw_wavefront"]
