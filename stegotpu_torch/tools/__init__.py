"""The port's soak and trace tools, each runnable as
``python -m stegotpu_torch.tools.<name>``:

- ``reference_model``: the scalar scipy oracle of the QIM/DCT semantics
  (a copy of tests/reference_model.py, so that the package reaches into no
  test directory);
- ``soak_kernels`` (tools/soak_kernels.py): the kernels against that
  oracle on random configurations;
- ``soak_product`` (tools/soak_product.py): random file-to-file embed and
  extract round trips through the whole product surface;
- ``profile_roundtrip`` (tools/profile_roundtrip.py): a torch.profiler
  trace of K4, the fused round trip, at 1080p.

Each takes ``--device`` (default: the card; ``cpu`` runs the kernels'
plain versions). Nothing runs at import.
"""
