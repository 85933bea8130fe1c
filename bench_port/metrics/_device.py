"""Kernel names the device readers look for in the trace."""

import re

#: every fused likelihood kernel of the port, by its CUDA template's name
FUSED = re.compile(r"fused_ll_(wide_|bf16_)?tiles|chains_tiles")
K3_VG = re.compile(r"chains_tiles<float,\s*true>")
K2_WIDE = re.compile(r"fused_ll_wide_tiles<true\b")
