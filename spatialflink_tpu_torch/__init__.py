"""spatialflink_tpu_torch — the PyTorch/CUDA port of spatialflink_tpu.

The JAX package ``spatialflink_tpu`` is the reference; this package computes
the same answers with PyTorch on the host side and hand-written CUDA C++
kernels (``csrc/``) for Hopper (``sm_90a``). It imports nothing of JAX and
nothing of ``spatialflink_tpu``.

Ported so far: windowed point-stream range queries, options 1 (point
query), 6 (polygon query) and 11 (linestring query), through
:func:`spatialflink_tpu_torch.driver.run_option` and the operator API.
Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``, where every kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"

from spatialflink_tpu_torch.index import UniformGrid

__all__ = ["UniformGrid", "__version__"]
