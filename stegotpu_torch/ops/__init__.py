"""Device kernels: DCT helpers, the QIM oracle and the CUDA stripe kernels."""
