"""Core of the port: the CGRA estimation framework on PyTorch.

Copied verbatim from the reference (framework-free): ``isa``,
``program``, ``physical``, ``trace``, ``detailed``.  Ported to torch:
``hwconfig``, ``memory``, ``cgra``, ``characterization``, ``dse``.
Submodules are imported explicitly (``from repro_torch.core import
dse``), so importing this package stays cheap.
"""
