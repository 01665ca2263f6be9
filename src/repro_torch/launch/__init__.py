"""Launchers (ports of ``repro/launch``): the training launcher
(:mod:`.train`), device meshes on ``torch.distributed`` (:mod:`.mesh`) and
the dry run of the registry's cells on the meta device (:mod:`.dryrun`)."""
