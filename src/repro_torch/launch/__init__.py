"""Launchers of the port: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``; the production and test meshes
(``mesh.py``), shape-only specs on the meta device (``specs.py``) and local
multi-process runs (``spmd.py``). The reference's dry-run is not ported
yet (ROADMAP §1 item 6)."""
