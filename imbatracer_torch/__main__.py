"""`python -m imbatracer_torch <scene.scene> <out.png> [flags]`: the
command-line renderer (frontend/cli.py)."""

from .frontend.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
