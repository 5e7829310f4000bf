"""Checkpointing (counterpart of ``autodist_tpu/checkpoint``): the
canonical and update-space savers with their manifests, and the restore
that reshards an R-way checkpoint onto R' replicas."""


def __getattr__(name):
    # lazy: importing the package pulls in neither the session nor
    # torch.distributed.checkpoint
    if name in ("Saver", "SavedModelBuilder", "load_serving"):
        from autodist_tpu_torch.checkpoint import saver

        return getattr(saver, name)
    if name == "reshard_restore":
        from autodist_tpu_torch.checkpoint.reshard import reshard_restore

        return reshard_restore
    if name in ("load_manifest", "build_manifest", "geometry_matches"):
        from autodist_tpu_torch.checkpoint import manifest

        return getattr(manifest, name)
    raise AttributeError(f"module 'autodist_tpu_torch.checkpoint' has no attribute {name!r}")
