"""graphik_tpu_torch: the PyTorch / CUDA port of graphik_tpu.

Distance-geometric batched inverse kinematics on an NVIDIA GPU. The layout
mirrors the JAX package (robots/, io/, graphs/, utils/, ops/, solvers/,
api.py); graphik_tpu stays the reference the port is tested against. The
port imports torch and never jax. Kernels written by hand live in csrc/ and
are built with nvcc on first use (ops/_build.py).
"""

__version__ = "0.1.0"
