"""Command-line front ends of the port: ``interactive_vqa`` (one-image VQA and
report generation from flags or a REPL) and ``serve_http`` (the unified text
and image serving daemon). Run them as ``python -m
unimedvl_tpu_torch.scripts.<name> --help``."""
