"""Entry points: the serving CLI (``python -m repro_torch.launch.serve``)
and the spec-driven dry run (``python -m repro_torch.launch.dryrun_cascade``),
the port's counterparts of ``repro.launch.serve`` and
``repro.launch.dryrun_cascade``."""
