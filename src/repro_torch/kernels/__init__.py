"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``confidence.confidence_fused`` — replaces the Pallas
  ``src/repro/kernels/confidence.py:confidence_fused``.
* ``flash_attention.flash_attention`` — replaces the Pallas
  ``src/repro/kernels/flash_attention.py:flash_attention``.
* ``selective_scan.selective_scan`` — replaces the Pallas
  ``src/repro/kernels/selective_scan.py:selective_scan``.

A wrapper given a CUDA tensor launches its kernel (built from ``csrc/`` at
the first call, see ``_build``) or raises; given a CPU tensor it runs the
plain PyTorch version.  Each wrapper counts its calls that launched the
kernel in its module's ``launches`` (a launch recorded into a CUDA graph
counts once, at capture).
"""
