"""Launchers: meshes (``mesh``), the multi-pod dry-run (``dryrun``) and
the train / serve drivers (``python -m repro_torch.launch.serve``)."""
