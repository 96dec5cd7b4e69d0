"""Multi-process training and rendering over ``torch.distributed``
(counterpart of parallel/): ``runtime`` starts the process group and maps
ranks onto a (data, tile) mesh, ``comm`` holds the collectives the step
needs, ``shard`` the mesh's train step and the tile-sharded render."""
