"""repro_torch.dist — the port's distribution layer.

The mesh context the serving cell enters (:mod:`repro_torch.dist.ctx`,
single-device no-ops) and the error-feedback compressed gradient sync
(:mod:`repro_torch.dist.compress`, a ring over a ``torch.distributed``
process group).  The mesh programs are ROADMAP queue A items 4.2-4.4.
"""
