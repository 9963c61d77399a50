"""Scale-out: the JAX package's mesh as a torch.distributed process group
(``mesh``), its collectives (``collectives``), multi-host input
(``multihost``) and sequence parallelism (``sequence``)."""
