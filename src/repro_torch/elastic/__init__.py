"""``repro_torch.elastic``: restore a paper-trainer or zoo checkpoint onto
a ring of another size. ``MeshGeometry`` records the source ring in the
checkpoint's meta, ``plan_reshard`` intersects the src/dst row
partitions, the transforms in ``reshard`` re-pack what the ring size was
baked into (the knn and LSH CSRs exactly, the sketch buckets by
re-hashing, DGC's residuals mass-preservingly), and
``reshard_paper_snapshot`` / ``reshard_zoo_snapshot`` drive a whole
snapshot through the heads' ``reshard_state`` seam (the zoo's also
re-pads the vocab rows of its model to the dst ring). Entry points: ``fit(resume="reshard")``,
``restore(reshard=True)``, the launcher's ``--resume-reshard`` and
``repro_torch.resilience.elastic_kill_and_recover``."""
from repro_torch.elastic.apply import (analytic_reshard_ledger,
                                       reshard_paper_snapshot,
                                       reshard_zoo_snapshot)
from repro_torch.elastic.plan import (MeshGeometry, ReshardError, ReshardPlan,
                                      RowTransfer, geometry_from_meta,
                                      plan_reshard, validate_geometry)
from repro_torch.elastic.reshard import (decompress_graph, leaf_bytes,
                                         lsh_bucket_map, rebucket_sketch,
                                         redistribute_dgc, repack_knn_aux,
                                         repack_lsh_aux, resize_vocab_rows,
                                         row_block)

__all__ = [
    "MeshGeometry", "ReshardError", "ReshardPlan", "RowTransfer",
    "geometry_from_meta", "plan_reshard", "validate_geometry",
    "reshard_paper_snapshot", "reshard_zoo_snapshot",
    "analytic_reshard_ledger", "decompress_graph",
    "leaf_bytes", "lsh_bucket_map", "rebucket_sketch", "redistribute_dgc",
    "repack_knn_aux", "repack_lsh_aux", "resize_vocab_rows", "row_block",
]
