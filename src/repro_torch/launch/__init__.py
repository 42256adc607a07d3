"""repro_torch.launch — entry points: the one-card trainer
(``python -m repro_torch.launch.train``), the serving driver
(``launch.serve``) and the dry-run (``python -m
repro_torch.launch.dryrun``, over the shapes of ``launch.inputs`` and
the meshes of ``launch.mesh``).  Training on a model-parallel mesh is
not ported yet."""
