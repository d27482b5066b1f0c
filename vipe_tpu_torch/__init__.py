"""PyTorch + CUDA port of vipe_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (``ops/``, ``models/``, ``slam/``,
``streams/``, ``utils/``, ``pipeline/``, ``cli/``) and its public layouts
(NHWC feature maps, ``(E, h1, w1, h2, w2)`` correlation volumes, ``(u, v)``
coords, SE3 as ``[t, q]``).  The correlation-window lookup runs as a
hand-written CUDA kernel (``csrc/corr_lookup.cu``) on CUDA tensors and as
its plain PyTorch version on CPU tensors.
"""

__version__ = "0.1.0"
