"""Serving and training under a (dp, sp, tp) mesh of ``torch.distributed``
ranks: the counterpart of ``pangu_tpu/parallel`` (``mesh``: the process
group, the mesh and its collectives; ``sharding``: which dimension splits
over which axis, the active mesh, the gradient sum; ``launch``: a world of
N ranks on one machine)."""
