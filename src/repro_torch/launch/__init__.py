"""repro_torch.launch — entry points: the trainer (``python -m
repro_torch.launch.train``, on one card or meshed under ``torchrun``),
the serving driver (``launch.serve``) and the dry-run (``python -m
repro_torch.launch.dryrun``, over the shapes of ``launch.inputs`` and
the meshes of ``launch.mesh``); ``launch.mesh.launcher_group`` joins a
launcher's process group."""
