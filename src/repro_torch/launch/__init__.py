"""Launchers of the port: ``python -m repro_torch.launch.<tool>``.

  train            the training loop at a runnable scale (one device)
  mesh             the production meshes over a fake process group
  dryrun           every (arch x shape x mesh) cell traced on the host
  costrun          per-device FLOP, byte and collective counts per cell
  roofline         the roofline terms on the H100's constants
  particle_dryrun  the halo engine on the production meshes
  report           the dry-run and roofline tables
"""
