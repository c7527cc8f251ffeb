"""Utilities of the port: logging setup, stage timers, profiler traces.

The JAX package's ``utils/jaxcache.py`` (a persistent jit compilation
cache) has no counterpart: PyTorch runs eagerly, and the CUDA kernels are
built once into ``stegotpu_torch/_build/`` (ops/_build.py).
"""
