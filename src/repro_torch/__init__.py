"""repro_torch — the PyTorch/CUDA port of the property-graph system.

Mirrors the layout and names of the reference package module for module;
imports ``torch`` and ``numpy`` only.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
