"""stegotpu_torch — the PyTorch/CUDA port of stegotpu.

Secure video steganography (QIM parity embedding in 8x8 DCT blocks of video
luma, with P-256 ECDH + HKDF-SHA256 + AES-256-GCM + SHA3-256) for one
NVIDIA H100, beside the JAX package ``stegotpu`` that stays the reference.
The two QIM stripe kernels on the default embed/extract path are CUDA C++
written for Hopper (``csrc/qim_stripe.cu``, bound in ``ops/stripe_kernel.py``);
the host layers are copies of ``stegotpu``'s, because importing any
``stegotpu`` module imports JAX.

Importing this package imports nothing heavy: the pipeline is
``stegotpu_torch.pipeline``.
"""

__version__ = "0.1.0"
