"""Kernel variants kept beside the product path, counterpart of
``stegotpu/ops/experimental``.

- ``qim_fast``: the image-layout QIM embed/extract and the u8 state plane
  (``stegotpu/ops/experimental/qim_fast.py``), plain PyTorch as the JAX
  package left it to XLA.
- ``kron_kernel``: the dense 64x64 Kronecker-DCT embed and extract (K7, K8;
  ``stegotpu/ops/experimental/pallas_kron.py``), hand-written CUDA kernels
  (csrc/qim_kron.cu) with their plain versions. On a TPU, Mosaic never
  compiled the Pallas kernels (they ran interpreted only); on the card
  they are compiled.

Nothing in the product path imports these modules.
"""
