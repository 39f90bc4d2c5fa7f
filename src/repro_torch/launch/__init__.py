"""Launchers of the port: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``. The reference's mesh, spec and
dry-run launchers are multi-device and are not ported yet (ROADMAP §1)."""
