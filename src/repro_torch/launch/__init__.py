"""Launchers of the port: ``python -m repro_torch.launch.train``. JAX's
dry-run, cost, roofline, mesh and report tools are not ported yet (ROADMAP
Queue 1 item 13.6)."""
