"""The A/B studies of the stripe kernels, on the card.

Counterparts of the JAX package's kernel-bearing study scripts, under the
same basenames, each runnable as ``python -m stegotpu_torch.studies.<name>``:

- ``extract_ablation`` (benchmarks/extract_ablation.py): K9, the extract
  kernel with stages removed;
- ``ab_packed_payload`` (benchmarks/ab_packed_payload.py): K10, the embed
  with a bit-packed payload input;
- ``dualchain_r5`` (benchmarks/dualchain_r5.py): K11, the fused round trip
  with two frames per thread as independent chains;
- ``roofline_r4`` (benchmarks/roofline_r4.py): K12, the copy and DMA-set
  floors beside the embed and the fused round trip;
- ``device_roofline`` (tools/device_roofline.py): K12's variants read from
  the device timeline of ``torch.profiler``.

Each module holds its kernels' wrappers (launched through
``stripe_kernel.launch``, which counts them), their plain PyTorch
versions, and a ``main(argv)`` whose defaults are the JAX
script's shapes. Times are the card's own: CUDA events around calls queued
behind a sleep kernel (harness.queued_ms). Without a CUDA device each
``main`` exits non-zero. Nothing runs at import.
"""
