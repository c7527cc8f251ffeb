"""``python -m stegotpu_torch``: the port's command-line interface
(stegotpu_torch/cli.py)."""

from stegotpu_torch.cli import main

raise SystemExit(main())
