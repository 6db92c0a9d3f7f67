"""`python -m imbatracer_torch <scene.scene> <out.png> [flags]`: the
command-line renderer (frontend/cli.py)."""

from .frontend.cli import main

raise SystemExit(main())
