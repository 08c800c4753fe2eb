"""The multi-device tier (port of ocn_tpu/parallel/): ranks and collectives
(``launch``), the dp x tp mesh (``mesh``), the within-chunk shard context of
the mesh step (``shard``), the explicit DP step (``spmd``), node-sharded
SpMMs (``node_sharded``) and node-sharded training and eval
(``sharded_graph``)."""
