"""PyTorch + CUDA port of the smcsmc_tpu particle-filter sweep.

The module names mirror ``smcsmc_tpu`` so each counterpart is easy to find
(``kernels.tree``, ``kernels.likelihood``, ``smc``, ``em``, ``cli``).  The
port covers the plain sweep: one population, piecewise-constant Ne, phased
data, one chunk.  The recombination trip runs as a hand-written CUDA kernel
(``csrc/trip.cu``) on a CUDA device and as plain torch on the CPU.

The package stands alone: it imports neither jax nor anything of
``smcsmc_tpu``.  Its host-side modules ``demography``, ``pattern``, ``segio``,
``simulate`` and ``outfmt``, and the demography helpers in ``cli``, are copies
of the JAX package's numpy-only modules, kept letter for letter.
"""

__version__ = "0.1.0"
