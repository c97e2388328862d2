"""Replicas sharded over devices on torch.distributed (``mesh``) and the
launcher of its ranks (``launch``)."""
