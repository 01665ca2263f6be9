"""Launchers (ports of ``repro/launch``): the training launcher
(:mod:`.train`), device meshes on ``torch.distributed`` (:mod:`.mesh`),
the collectives over a mesh's axes that the mesh routes call
(:mod:`.collectives`) and the dry run of the registry's cells on the meta
device (:mod:`.dryrun`)."""
