"""The mesh: a multi-shard index served over a grid of devices by one
controller (counterpart of elasticsearch_tpu/parallel/). ``sharded``
holds the grid (``Mesh``, ``make_mesh``) and the sharded programs,
``mesh_executor`` the serving backend."""
