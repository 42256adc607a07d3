"""repro_torch.launch — entry points: the one-card trainer
(``python -m repro_torch.launch.train``).  The reference's mesh, dry
run and multi-pod serving need a mesh and are not ported yet."""
