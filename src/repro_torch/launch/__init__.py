"""Launchers of the port, the counterparts of the JAX package's
``launch/``: ``train`` and ``serve`` (the entry points), ``dryrun`` (the
plan of every arch x shape on the production meshes, with an H100
roofline), and what the dry run is made of: ``mesh`` (DeviceMeshes on
an in-process fake group), ``shardings`` (the reference's sharding rules
as per-dim specs and DTensor placements), ``specs`` (the dry-run cases)
and ``trace_analysis`` (per-device FLOPs, bytes and collectives of a
traced step)."""
