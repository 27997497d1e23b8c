"""repro_torch — the PyTorch/CUDA port of the foreseeing-decoding stack.

A second package beside the JAX reference ``repro``: the same sub-package
names (``configs``, ``models``, ``kernels``, ``core``, ``serving``), plain
tensor code in eager PyTorch, and every TPU kernel on the path replaced by
a kernel written by hand for Hopper (``kernels/csrc``).  It imports
nothing of JAX or of ``repro``.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
