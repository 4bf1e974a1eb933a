"""CGRA application kernels used in the paper's studies.

mibench: 5 MiBench-inspired benchmark kernels (Section 2 validation)
conv:    4 convolution mappings from Carpentieri et al. [16] (Section 3.1)
"""
from .common import KernelCase
from . import conv, mibench
