"""The port's measuring entry points beside the CLI (torch twins of the
repository's tools/ and scripts/golden_check.py): run_bench,
render_golden and golden_check, each run as `python -m
imbatracer_torch.tools.<name>`."""
