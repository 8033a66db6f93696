"""Sharding on a single-controller mesh of torch devices.

Port of ``sam2consensus_tpu/parallel/``: the mesh over an explicit device
list (:mod:`.mesh`), the collectives between its shards
(:mod:`.collectives`), the placement table (:mod:`.partition`), the
shared state and tail work (:mod:`.base`), the three layouts (:mod:`.dp`,
:mod:`.sp`, :mod:`.dpsp`) and the model that picks one (:mod:`.auto`).
"""
