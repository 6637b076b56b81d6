"""PyTorch/CUDA port of ``wssdl_bus_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here mirrors
its counterpart's name and place and is tested against it.  The port imports
``torch``, numpy, PIL and scipy, and nothing of JAX or of ``wssdl_bus_tpu``.
Its hand-written CUDA kernels (greedy NMS; ROI max-pool forward and
backward) live in ``csrc/`` and are built with ``nvcc`` on first use
(``ops/_build.py``).

Entry points (``build_detector``, ``Engine``, ``evaluate.detect``) run on the
CUDA device unless the caller passes ``device="cpu"``; without a card and
without that argument they raise.
"""

from wssdl_bus_tpu_torch.utils import warm_cpu_vector_math as _warm

# before any parallel exp/log of the process: see the function's docstring
_warm()
del _warm
