"""repro_torch.dist — the port's distribution layer.

Only the mesh context the serving cell enters is ported so far
(:mod:`repro_torch.dist.ctx`, single-device no-ops); gradient compression
and the mesh programs are ROADMAP queue A item 4.
"""
