"""repro_torch.dist — the port's distribution layer.

Partition specs and their ``torch.distributed.tensor`` placements
(:mod:`repro_torch.dist.sharding`), the mesh context the model code
consults at its activation boundaries (:mod:`repro_torch.dist.ctx`), a
train step on a ``DeviceMesh`` in local view
(:mod:`repro_torch.dist.spmd`) and the error-feedback compressed gradient
sync (:mod:`repro_torch.dist.compress`).  ``launch.steps.lower_program``
and ``launch.dryrun`` price the step programs on a fake production mesh.
"""
